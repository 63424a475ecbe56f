"""Hand-written Hopper kernels of the port.

Each kernel package mirrors `repro.kernels`: a plain PyTorch ``ref.py``, the
kernel (CUDA C++ sources under ``csrc/`` plus a Python wrapper that builds
them at first use), and an ``ops.py`` that dispatches by tensor device: CPU
tensors take the plain version, CUDA tensors launch the kernel or raise.
"""
