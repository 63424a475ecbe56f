"""4-bit codebook-index GEMM with fused epilogue (the serve path's kernel).

``ref.py`` is the plain PyTorch version, ``lut_matmul.py`` builds and
launches the CUDA kernel in ``csrc/lut_matmul.cu``, and ``ops.py`` holds the
encode/pack utilities and the device dispatch.
"""
