from repro_torch.kernels.contract import KernelContract, register
from repro_torch.kernels.sddmm.ops import (COUNTER,  # noqa: F401
                                           WALK_COUNTERS, sddmm, sddmm_cuda,
                                           sddmm_plain, walk)

# narrower than the reference's sddmm contract (blocks 1..128 over t x t
# tiles with t <= 128 dividing m and k): the CUDA kernel samples b x b
# blocks directly, with b in {4, 8, 16, 32, 64}; n is free (ragged chunks
# of N are masked).  The plan maps the reference's other blocks onto
# these (``sparse.plan.kernel_tile``), checked at plan time: each block
# is sampled as its sub-blocks of the largest tile dividing b and merged
# back to [nnz, b, b] (b = 128: four 64 x 64); sub-blocks below 4 (b in
# {1, 2, 3, 5, 6, ...}) are sampled on the 4 x 4 tiles the forward
# packed them into and gathered out through the forward's pack index
# (BLOCK_SIZES is not widened)
CONTRACT = register(KernelContract(
    kernel="sddmm",
    routes=("sddmm_cuda",),
    dtypes=("float32", "bfloat16", "float16"),
    min_block=4,
    max_block=64,
    divisibility=("m % b == 0", "k % b == 0", "b in (4, 8, 16, 32, 64)"),
    grid="(m // b) x splits blocks (splits from ops.n_splits), each "
         "walking its block-row's run of blocks in groups through a CSR "
         "row pointer and its slice of N in staged chunks (mma, 16-bit, "
         "b >= 16: a TMA producer warp + 16 mma.sync consumer warps, "
         "chunks of 64 tokens; ffma: 256 threads, chunks of 32 or 16); "
         "plus one reduce launch when splits > 1",
    capacity="exact",
    replaces="src/repro/kernels/sddmm/sddmm.py:53 sddmm_tiles_call",
))
