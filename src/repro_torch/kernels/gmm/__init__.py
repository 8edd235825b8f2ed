"""Expert-grouped GEMM (``csrc/gmm.cu``, the port of the reference's
``gmm_call``: MoE's expert products through ``sparse.batched_matmul``)
and the device-side tile packing of runtime patterns (the grouped
dynamic routes, which run the dsmm kernel on the packed tiles, so their
contract is ``kernels/dsmm``'s)."""
from repro_torch.kernels.contract import KernelContract, register
from repro_torch.kernels.gmm.ops import (COUNTER, gmm,  # noqa: F401
                                         gmm_cuda)
from repro_torch.kernels.gmm.ref import gmm_ref  # noqa: F401

# the grouped GEMM serves route dense_cuda's batched_matmul op (one
# [C, D] @ [D, F] problem per expert), not a route of its own: routes
# are empty, as for bs_attn, and dense_cuda stays dense_mm's.  m, k, n
# and b of ``admits`` are C, D, F and the row tile tm.  Against the
# reference's gmm_call (any tm, tf | F, td | D): narrower in the row
# tile, tm <= 64 (the rows a block holds; batched_matmul takes the
# largest multiple of 8 <= 64 dividing C); wider in F and D, any size
# (the kernel tiles them by 64 and 32 and masks the edges; tf and td are
# only checked to divide F and D, as the reference checks them).  An
# expert id outside [0, E) gives zero rows and reads nothing of w.
CONTRACT = register(KernelContract(
    kernel="gmm",
    routes=(),
    dtypes=("float32", "bfloat16", "float16"),
    min_block=1,
    max_block=64,
    divisibility=("m % b == 0",),
    grid="(T / tm row tiles) x ceil(F / 64) blocks of 256 threads, each "
         "reading its expert id on the device and looping over D in "
         "chunks of 32",
    capacity="exact",
    replaces="src/repro/kernels/gmm/gmm.py:41 gmm_call",
))
