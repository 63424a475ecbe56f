"""PyTorch/CUDA port of the layer-wise weight-selection pipeline.

A package beside `repro` (the JAX reference) with the same module layout and
public names, for one NVIDIA H100. This slice covers the serve path: reading
a saved `CompressionPlan`, packing every restricted layer into 4-bit
`ServeArtifact`s, and running the CNN forward through the hand-written CUDA
LUT-GEMM kernel (`repro_torch.kernels.lut_matmul`).

The package imports torch and numpy only. Importing it touches no CUDA
device and builds no kernel: kernels compile at first use.

    python -m repro_torch export --plan-in BASE --plan-out BASE2
    python -m repro_torch serve  --plan-in BASE [--device cpu]
"""

__version__ = "0.1.0"
