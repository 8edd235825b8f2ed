from repro_torch.kernels.bsmm.ops import (COUNTER, bsmm_nt,  # noqa: F401
                                          bsmm_nt_cuda, bsmm_nt_plain)
from repro_torch.kernels.contract import KernelContract, register

# narrower than the reference's bsmm contract (blocks 1..128, any tile
# from _pick_tiles): the CUDA kernel walks square b x b tiles
# (tm = tk = b) with b in {4, 8, 16, 32, 64}; n is free (ragged token
# tiles are masked)
CONTRACT = register(KernelContract(
    kernel="bsmm",
    routes=("static_cuda",),
    dtypes=("float32", "bfloat16", "float16"),
    min_block=4,
    max_block=64,
    divisibility=("m % b == 0", "k % b == 0", "b in (4, 8, 16, 32, 64)"),
    grid="n <= 128 / b (b <= 32): m // b blocks whose 8 warps share "
         "the row-tile's tiles; else (m // b) x ceil(n / 64) blocks, each "
         "walking its row-tile's b x b tiles through a CSR row pointer",
    capacity="exact",
    replaces="src/repro/kernels/bsmm/bsmm.py:50 bsmm_call",
))
