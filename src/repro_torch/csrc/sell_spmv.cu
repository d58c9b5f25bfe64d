// SELL-C-sigma SpMV for Hopper.
//
// Replaces: repro/kernels/sell_spmv.py::sell_spmv_arrays (the Pallas kernel
// _sell_kernel), together with the per-chunk scale of repro/kernels/sell.py
// and the inverse-permutation gather sell_spmv_scatter around it.
//
// Bound: memory.  One SpMV streams every stored slot once -- val (1-8 B) and
// col (4 B) for sum_c w_c * C slots, zero padding included -- plus the
// chunk table, the permutation, x and y.  On the N = 1,201,200 Holstein
// surrogate (16.8 M nnz) that is at least 8 B/nnz in f32, ~134 MB, so at
// least ~40 us at the H100 SXM's 3.35 TB/s (less on a card whose power
// limit holds it below that rate); on the hybrid plan's SELL remainder
// (5.47 M nnz, C = 8, sigma 256, f32 values, f64 x) ~71 MB, ~21 us.
// x (9.6 MB in f64) stays resident in the 50 MB L2, so its gathers cost L2
// traffic, one 32-byte sector each, not device-memory traffic.
//
// The first design (one thread per chunk row, walking its own slots) made
// each thread a chain of dependent round trips -- the chunk table, then
// val / col one slot at a time, then x[col], then perm and the scattered
// store -- behind only ~4.5 slots a row on the hybrid remainder, and ran at
// 30 % of the bound: latency, not bandwidth, held it (as it held the first
// CSR kernel).
//
// Design: blocks of whole chunks (after the CSR kernel's row blocks).  A
// SELL chunk is a contiguous column-major (width_c, C) slab at chunk_ptr[c],
// so a run of whole chunks is one contiguous span of col and val.  The host
// partition (kernels/sell_spmv.py::sell_chunk_blocks, cached per container)
// cuts the chunks into blocks holding at most kSellBudget stored slots (and
// rows); a chunk over the budget gets a block of its own.  A CUDA block of
// 256 threads takes one chunk block:
// * several chunks: the epilogue's operands (chunk table, perm, scale, and
//   the row of add_to) are loaded first, then the block's span is streamed
//   coalesced, kSellPerThread independent col / val loads a thread in flight
//   (cache-streaming, so x keeps L1 and L2), then the x gathers; the
//   products land in shared memory in the accumulator type; then one thread
//   a row (lane l of chunk c) sums its slots from shared memory in slot
//   order;
// * one chunk, however wide: the block walks it in G = 256 / C groups of C
//   lanes (group g takes slots g, g + G, ..., four loads ahead), and each
//   lane sums its G partial sums in group order (C > 256: a thread a row).
// Both orders are fixed by the partition, so two calls give the same bits
// (no floating-point atomics).  A budget of 512 slots (two loads a thread)
// beat 256, 1024 and 2048 on the hybrid remainder.  With the round trips
// gone, the x gathers hold the kernel: one L2 sector for each stored slot,
// at random within the surrogate's band (python -m
// repro_torch.testing.sell_ablation times it with the gathers made
// coalesced on purpose, and the first design beside it).  The per-chunk scale and the inverse
// permutation are fused into the store, y[perm[q]] = scale * acc, which is
// the reference's gather because perm is a bijection on the real rows; so
// is the hybrid plan's add: with add set, y holds the DIA kernel's output
// and each real row is updated in place, y[row] = y[row] + scale * acc, by
// the one thread that owns it.
#include "sell_spmv.cuh"

extern "C" int sell_spmv(int vcode, int acc64, const void* chunk_ptr,
                         const void* chunk_width, const void* col,
                         const void* val, const void* scale, const void* perm,
                         const void* x, void* y, int add, int64_t n_chunks, int C,
                         int64_t n_rows, const void* blocks, int64_t n_blocks,
                         void* stream) {
  const int rc = launch_sell_spmv(vcode, acc64, chunk_ptr, chunk_width, col, val, scale, perm,
                                  x, y, add, n_chunks, C, n_rows, blocks, n_blocks,
                                  (cudaStream_t)stream);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
