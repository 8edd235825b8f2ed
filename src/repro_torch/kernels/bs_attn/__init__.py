from repro_torch.kernels.bs_attn.ops import (COUNTER,  # noqa: F401
                                             HEAD_DIM_COUNTERS,
                                             WALK_COUNTERS, bs_attn,
                                             bs_attn_cuda, kernel_walk,
                                             mask_to_pairs)
from repro_torch.kernels.bs_attn.ref import (attend_plain,  # noqa: F401
                                             bs_attn_ref)
from repro_torch.kernels.contract import KernelContract, register

# block-sparse flash attention, outside the matmul route table (routes
# empty, as in the reference).  Against the reference's contract
# (tiles 1..128, any head dim): narrower in the head dim, which must be
# one of 32, 64, 128, 192, 256 (192: MLA's q.k head); wider in the tiles, any bq and bkv from 1 to
# 512 (the tile ``attend_train`` starts from; the kernel walks its own
# 64-key chunks inside them).  Every q row must see at least one key
# (the reference leaves a row that sees none undefined; ``bs_attn``
# raises on such a causal mask), and the mask must give every q tile a
# kv tile (``mask_to_pairs`` raises).  m and k of ``admits`` are Sq and
# Skv, b the tile.
CONTRACT = register(KernelContract(
    kernel="bs_attn",
    routes=(),
    dtypes=("float32", "bfloat16", "float16"),
    min_block=1,
    max_block=512,
    divisibility=("m % b == 0", "k % b == 0"),
    grid="(blocks of <= 64 query rows: ceil(bq / 64) per q tile, or 64 "
         "/ bq whole q tiles when bq < 64) x batch*heads, each walking "
         "its row's visible kv tiles from a CSR over mask_to_pairs's "
         "pairs in 64-key chunks; 16-bit: one wgmma consumer warpgroup "
         "+ one TMA producer warp over a 2-stage k/v ring; fp32: 256 "
         "threads of fp32 FMA",
    capacity="exact",
    replaces="src/repro/kernels/bs_attn/bs_attn.py:73 bs_attn_call",
))
