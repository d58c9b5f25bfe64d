"""PyTorch/CUDA port of the SpMV reproduction (Schubert/Hager/Fehske 2009).

The JAX package ``repro`` is the reference; this package re-implements its
main path -- Holstein-Hubbard matrix, storage formats, kernel registry, SpMV
plan, Lanczos -- the performance model, the sparse-weight layer
(``models.sparse.SparseLinear``), the grouped MoE expert GEMM
(``kernels.ops.grouped_gemm``), the serving and distributed layers and the
LM stack with its token engine (``models.registry``, ``serve.Engine``,
``launch.serve``), its training path (``train``, ``launch.train``) and the
dry-run and roofline tools (``launch.{dryrun,roofline,hillclimb}``,
``utils.{op_flops,collectives}``) in PyTorch, with hand-written CUDA kernels
for Hopper in ``csrc/``.  It imports neither ``jax`` nor ``repro``.

Entry points run on the card: a plan or a solve asked for no ``device``
raises when CUDA is absent instead of falling back to the CPU.  Pass
``device="cpu"`` to run the plain PyTorch kernels on the host.
"""
