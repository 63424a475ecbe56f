"""Fused weight fake-quantization of QAT (the training path's kernel).

``ref.py`` is the plain PyTorch version, ``fake_quant.py`` builds and
launches the CUDA kernel in ``csrc/fake_quant.cu``, and ``ops.py`` holds the
input checks, the device dispatch and the straight-through estimator.
"""
