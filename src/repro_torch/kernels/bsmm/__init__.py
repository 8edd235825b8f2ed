from repro_torch.kernels.bsmm.balanced import (  # noqa: F401
    COUNTER as BALANCED_COUNTER, bsmm_balanced, bsmm_balanced_cuda,
    bsmm_balanced_from_plan, bsmm_balanced_plain)
from repro_torch.kernels.bsmm.ops import (  # noqa: F401
    COUNTER, WALK_COUNTERS, bsmm_nt, bsmm_nt_cuda, bsmm_nt_plain, walk)
from repro_torch.kernels.contract import KernelContract, register

# narrower than the reference's bsmm contract (blocks 1..128, any tile
# from _pick_tiles): the CUDA kernel walks square tiles with tm = tk in
# {4, 8, 16, 32, 64}; n is free (ragged token tiles are masked).  The
# plan checks this contract at the tile it packs (``sparse.plan.
# kernel_tile``), on m and k padded to it: each block split exactly into
# sub-blocks of the largest tile dividing b (else 2 or 1), those below 4
# packed into 4 x 4 tiles (``plan_packing`` with tile != b, as the
# reference's pack_tiles): b = 128 as four 64 x 64 blocks, b = 12 as
# nine 4 x 4, b = 3 as 1 x 1 blocks packed 4 x 4
CONTRACT = register(KernelContract(
    kernel="bsmm",
    routes=("static_cuda",),
    dtypes=("float32", "bfloat16", "float16"),
    min_block=4,
    max_block=64,
    divisibility=("m % b == 0", "k % b == 0", "b in (4, 8, 16, 32, 64)"),
    grid="decode (n <= 4 at b in (16, 32) in 16-bit, n <= 128 / b "
         "else, b <= 32): m // b blocks whose 8 warps share the "
         "row-tile's tiles; mma (16-bit, b in (16, 32, 64)): ceil((m // "
         "b) / R) x ceil(n / T) blocks of 16 warps (R x T = 16 block-rows "
         "x 128 tokens at b = 16, 16 x 64 at 32, 8 x 64 at 64) on the "
         "schedule the plan records: thread 0 streams the group's chunks "
         "of x by TMA, each warp copies its row's blocks stages ahead "
         "(cp.async) and runs mma.sync, K split into slices (fp32 "
         "partials, a reduce launch) where the blocks are too few to "
         "fill the card; ffma (the rest): (m // b) x "
         "ceil(n / 64) blocks, each walking its row-tile's b x b tiles "
         "through a CSR row pointer",
    capacity="exact",
    replaces="src/repro/kernels/bsmm/bsmm.py:50 bsmm_call",
))

# row-swizzled balanced walk: narrower than the reference's
# bsmm_balanced contract (blocks 1..128, tm/tk from _pick_tiles) in the
# same way as bsmm: square b x b tiles (tm = tk = b), b in {4, 8, 16, 32,
# 64}; the bin count is the plan's choice for the card: ceil(mb / R)
# where the walk is mma (``balanced.mma_bins``: a bin is one group of the
# walk), else ``balanced.card_bins`` (bins x token tiles >= 2 x 132 SMs,
# at least the reference's 8, at most one per row-tile); 8 on the CPU as
# in the reference; any bin count gives the same result
BALANCED_CONTRACT = register(KernelContract(
    kernel="bsmm_balanced",
    routes=("static_balanced_cuda",),
    dtypes=("float32", "bfloat16", "float16"),
    min_block=4,
    max_block=64,
    divisibility=("m % b == 0", "k % b == 0", "b in (4, 8, 16, 32, 64)"),
    grid="mma (16-bit, b in (16, 32, 64)): bins x ceil(n / T) blocks of "
         "16 warps, each bin (<= R block-rows) one group of bsmm's mma "
         "walk on the group schedule the plan records (R x T as bsmm's); "
         "ffma (the rest): bins x ceil(n / BN) blocks (BN = 256 / 128 / "
         "64 tokens at b = 4 / 8 / >= 16), each walking one snake-binned "
         "lane of the [bins, steps] visit schedule (pads -> appended zero "
         "tile)",
    capacity="exact",
    replaces="src/repro/kernels/bsmm/balanced.py:59 bsmm_balanced_call",
))
