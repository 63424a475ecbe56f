"""Systolic transition statistics of a tile batch (the profile path's kernel).

``ref.py`` is the plain PyTorch version, ``transition_energy.py`` builds and
launches the CUDA kernel in ``csrc/transition_energy.cu``, and ``ops.py``
holds the input checks and the device dispatch.
"""
