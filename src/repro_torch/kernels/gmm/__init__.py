"""Expert-grouped GEMM (``csrc/gmm.cu``, the port of the reference's
``gmm_call``: MoE's expert products through ``sparse.batched_matmul``)
and the device-side tile packing of runtime patterns (the grouped
dynamic routes, which run the dsmm kernel on the packed tiles, so their
contract is ``kernels/dsmm``'s)."""
from repro_torch.kernels.contract import KernelContract, register
from repro_torch.kernels.gmm.ops import (COUNTER,  # noqa: F401
                                         WALK_COUNTERS, Walk, gmm, gmm_cuda,
                                         walk)
from repro_torch.kernels.gmm.ref import gmm_ref  # noqa: F401

# the grouped GEMM serves route dense_cuda's batched_matmul op (one
# [C, D] @ [D, F] problem per expert), not a route of its own: routes
# are empty, as for bs_attn, and dense_cuda stays dense_mm's.  m, k, n
# and b of ``admits`` are C, D, F and the row tile tm.  Against the
# reference's gmm_call (any tm, tf | F, td | D): narrower in the row
# tile, tm <= 128 (the rows a block holds; batched_matmul takes tm = C
# for C <= 128, else the largest multiple of 8 <= 128 dividing C); wider
# in F and D, any size (the wgmma walk, 16-bit with D and F multiples of
# 8, tiles them by 64 / 128 through TMA, which fills the edges with
# zeros; the ffma walk by 64 and 32, masking the edges; tf and td are
# only checked to divide F and D, as the reference checks them).  An
# expert id outside [0, E) gives zero rows and reads nothing of w.
CONTRACT = register(KernelContract(
    kernel="gmm",
    routes=(),
    dtypes=("float32", "bfloat16", "float16"),
    min_block=1,
    max_block=128,
    divisibility=("m % b == 0",),
    grid="wgmma (16-bit, D and F multiples of 8): ceil(F / BN) x (T / tm) "
         "blocks (BN = 128, 64 where F <= 64) of one TMA producer "
         "warpgroup + 1 or 2 (tm > 64) wgmma consumer warpgroups over a "
         "4-stage ring of 64-deep D stages; ffma (the rest): (T / tm) x "
         "ceil(F / 64) blocks of 256 threads looping over D in chunks of "
         "32; each block reads its expert id on the device",
    capacity="exact",
    replaces="src/repro/kernels/gmm/gmm.py:41 gmm_call",
))
