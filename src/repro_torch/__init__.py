"""PyTorch/CUDA port of the PopSparse block-sparse serving and training
stack.

Mirrors the layout of the JAX package (``core/``, ``kernels/``,
``sparse/``, ``models/``, ``configs/``, ``serve/``, ``optim/``,
``data/``, ``train/``, ``checkpoint/``, ``launch/``) so each module's
counterpart is found under the same name.  The hot matmuls and the
sparse backward run through hand-written CUDA kernels for Hopper
(``kernels/bsmm``, ``kernels/dense_mm``, ``kernels/sddmm``); every
kernel keeps a plain PyTorch version beside it, used only for tensors
that lie on the CPU.

Entry points (``models.model.LM``, ``serve.engine.Engine``,
``sparse.plan``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
