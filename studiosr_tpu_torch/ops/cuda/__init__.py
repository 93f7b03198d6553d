"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers.

Each wrapper module holds the kernel's plain PyTorch version beside it; the
build is lazy, at the first launch on a CUDA tensor (``_build.py``).
"""
