// A plan's SpMV in one call: the launch record of a dia, sell or hybrid plan.
//
// Launches: kernel 2 (dia_spmv.cuh) and kernel 1 (sell_spmv.cuh), through
// the launchers their own entry points call; this file adds no kernel.
// kernels/plan_launch.py builds the record once, when the cuda SpMV entry
// of a dia, sell or hybrid container is built on the card, after the checks
// dia_spmv_arrays and sell_spmv_arrays run on every call; a call then
// passes only x, y and the stream.
//
// Bound: that of the kernels it launches.  What it removes is host time:
// one ctypes call of four arguments a plan call, where the entry made two
// of 14-16 arguments, each after its checks, and no padded copy of x (an
// allocation, a fill and a copy on the card).
//
// Design: the record's DIA part runs first on x itself, with pad0 = 0 and
// n_xpad = N: the kernel's bounds check gives the zeros the padded copy
// held, so the products are the same.  Its SELL part then runs with add
// set, each real row adding into the DIA output in place, as the hybrid
// entry's add_to does; a plan with one part launches that part alone,
// storing into y.  The sums, their order and the types are the entry's, so
// y is the entry's bit for bit.  Under CUDA graph capture the launches go
// to the capturing stream like any other.
#include "dia_spmv.cuh"
#include "sell_spmv.cuh"

// kernels/plan_launch.py::_PlanSpmv mirrors this layout field for field.
struct PlanSpmv {
  int32_t acc64;         // 1: x and y are f64, 0: f32
  int32_t parts;         // kPartDia | kPartSell
  int64_t n_rows;        // y
  int64_t n_x;           // x, read unpadded
  // kernel 2
  int32_t dia_vcode;
  int32_t nd;
  int64_t ld;
  const void* dia_data;
  const void* offsets;
  const void* dia_scales;  // NULL: no per-diagonal scales
  // kernel 1
  int32_t sell_vcode;
  int32_t C;
  int64_t n_chunks;
  int64_t n_blocks;
  const void* chunk_ptr;
  const void* chunk_width;
  const void* col;
  const void* val;
  const void* sell_scale;  // NULL: no per-chunk scales
  const void* perm;
  const void* blocks;      // the checked ChunkBlocks' starts
};

constexpr int32_t kPartDia = 1, kPartSell = 2;

// y = A x for the record r: x (n_x) and y (n_rows) contiguous in the
// record's accumulator type on the stream's device.  Returns the first
// failed launch's cudaGetLastError, else 0.
extern "C" int plan_spmv(const PlanSpmv* r, const void* x, void* y, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int dia = (r->parts & kPartDia) != 0;
  int rc = 0;
  if (dia) {
    rc = launch_dia_spmv(r->dia_vcode, r->acc64, r->dia_data, r->ld, r->offsets, r->dia_scales,
                         r->nd, x, r->n_x, 0, y, r->n_rows, s);
    if (rc == 0) rc = (int)cudaGetLastError();
  }
  if (rc == 0 && (r->parts & kPartSell))
    rc = launch_sell_spmv(r->sell_vcode, r->acc64, r->chunk_ptr, r->chunk_width, r->col, r->val,
                          r->sell_scale, r->perm, x, y, dia, r->n_chunks, r->C, r->n_rows,
                          r->blocks, r->n_blocks, s);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
