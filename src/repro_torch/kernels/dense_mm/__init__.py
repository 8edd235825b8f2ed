from repro_torch.kernels.contract import KernelContract, register
from repro_torch.kernels.dense_mm.ops import (COUNTER,  # noqa: F401
                                              WALK_COUNTERS, Walk, dense_mm,
                                              dense_mm_cuda, dense_mm_plain,
                                              walk)

# same admissibility as the reference's dense_mm contract: any shape
# (edges are masked or filled with zeros by TMA), no blocks.  ops.walk
# picks the walk; each is bound differently on the H100
CONTRACT = register(KernelContract(
    kernel="dense_mm",
    routes=("dense_cuda",),
    dtypes=("float32", "bfloat16", "float16"),
    min_block=1,
    max_block=1024,
    divisibility=(),
    grid="wgmma (16-bit, K and D multiples of 8; N > 16, or N <= 16 where "
         "its time model beats decode; bound by the tensor cores at "
         "prefill): ceil(D / BN) x ceil(N / BM) x slices blocks of one TMA "
         "producer warpgroup + BM / 64 wgmma consumer warpgroups over a "
         "4-stage ring, BM = BN = 128 (64 where the tiles fill under half "
         "the SMs), K split with a second, ordered reduce launch where "
         "under a quarter; decode (N <= 16; bound by reading w): "
         "ceil(D / (CL x 16 bytes)) x slices blocks of 256 threads, the "
         "slices one cluster adding through distributed shared memory in "
         "rank order (where x's fp32 K slice fits a block's shared memory, "
         "else wgmma or ffma); ffma (fp32 at N > 16, shapes TMA cannot "
         "take): "
         "ceil(D / 64) x ceil(N / 64) x slices blocks of 256 threads, fp32 "
         "FMA, K split with the reduce launch where the tiles do not fill "
         "the card",
    capacity="dense",
    replaces="src/repro/kernels/dense_mm/dense_mm.py:38 dense_mm_call",
))
