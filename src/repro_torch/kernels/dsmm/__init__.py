from repro_torch.kernels.contract import KernelContract, register
from repro_torch.kernels.dsmm.ops import (COUNTER,  # noqa: F401
                                          WALK_COUNTERS, dsmm, dsmm_cuda,
                                          dsmm_plain, dsmm_slots,
                                          encode_slots, walk)

# narrower than the reference's dsmm contract (blocks 1..128, row-sorted
# slots): the CUDA kernel takes b in {4, 8, 16, 32, 64, 128} (the grouped
# routes' tiles are b x b with b = t <= 128); the slots need only be
# contiguous per block-row, not ascending (the balanced order); n is free
# (ragged token tiles are masked).  Other blocks are mapped on the
# device, not widened in the kernel (``ops.kernel_operand``): each slot
# split into sub-blocks of the largest kernel block dividing b (else 2 or
# 1), those below 4 re-blocked (``ops.reblock`` embeds each in the 4 x 4
# block that covers it; slots sharing one add in the walk), the shape
# padded to the walked block, so the pattern never goes through the
# host; the plan checks this contract at the block the kernel walks
CONTRACT = register(KernelContract(
    kernel="dsmm",
    routes=("dynamic_cuda", "dynamic_grouped_cuda",
            "dynamic_grouped_balanced_cuda"),
    dtypes=("float32", "bfloat16", "float16"),
    min_block=4,
    max_block=128,
    divisibility=("m % b == 0", "k % b == 0",
                  "b in (4, 8, 16, 32, 64, 128)"),
    grid="one run-bounds pass over the S slots, then mma (16-bit, b >= "
         "16): ceil((m // b) / R) x ceil(n / T) blocks of 16 warps (R x T "
         "= 16 block-rows x 128 tokens at b = 16, 512 // b x 64 above): "
         "thread 0 streams the touched chunks of x by TMA, each warp "
         "copies its row's blocks stages ahead (cp.async) and runs "
         "mma.sync; ffma (the rest): (m // b) x ceil(n / BN) blocks (BN = "
         "256 / 128 / 64 tokens at b = 4 / 8 / >= 16), each walking its "
         "block-row's contiguous run of slots",
    capacity="slot_capacity",
    replaces="src/repro/kernels/dsmm/dsmm.py:53 dsmm_call",
))
