"""Hand-written Hopper kernels of the port.

Each kernel package holds its CUDA source under ``csrc/``, a ``ctypes``
wrapper in ``ops.py`` that launches the kernel for CUDA tensors (and
counts the launch), and the plain PyTorch version the wrapper uses for
CPU tensors.  Nothing here compiles at import: ``_build`` runs ``nvcc``
at the first launch.
"""
