from repro_torch.kernels.contract import KernelContract, register
from repro_torch.kernels.dense_mm.ops import (COUNTER,  # noqa: F401
                                              dense_mm, dense_mm_cuda,
                                              dense_mm_plain)

# same admissibility as the reference's dense_mm contract: any shape
# (edges are masked), no blocks
CONTRACT = register(KernelContract(
    kernel="dense_mm",
    routes=("dense_cuda",),
    dtypes=("float32", "bfloat16", "float16"),
    min_block=1,
    max_block=1024,
    divisibility=(),
    grid="n <= 16: ceil(d / 64) x slices split-K blocks (slices from "
         "ops.splitk_slices) plus one reduce launch; else ceil(d / 64) x "
         "ceil(n / 64) tiled blocks, K in steps of 16; 256 threads",
    capacity="dense",
    replaces="src/repro/kernels/dense_mm/dense_mm.py:38 dense_mm_call",
))
