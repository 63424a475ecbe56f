"""PyTorch/CUDA port of the layer-wise weight-selection pipeline.

A package beside `repro` (the JAX reference) with the same module layout and
public names, for one NVIDIA H100. Ported so far: the CNN target's
``profile`` and ``energy_model`` stages (systolic trace statistics through
the hand-written CUDA transition-statistics kernel,
`repro_torch.kernels.transition_energy`, then per-weight energy LUTs and
layer energy shares), and its ``export`` and ``serve`` stages (packed 4-bit
`ServeArtifact`s and the CNN forward through the hand-written CUDA LUT-GEMM
kernel, `repro_torch.kernels.lut_matmul`), with QAT and the layer-wise
schedule in both search modes between them; and the dense LM stack
(`repro_torch.models.lm`: prefill and decode, on the LUT GEMM when served)
with the LM target's five stages, its ``profile`` stage LM QAT through the
train steps of `repro_torch.launch.train` (checkpoints:
`repro_torch.checkpoint`), its ``serve`` stage the continuous-batching
engine of `repro_torch.serving`, pinned to one plan or routed across a
fleet of resident plans.

The package imports torch and numpy only. Importing it touches no CUDA
device and builds no kernel: kernels compile at first use.

    python -m repro_torch profile --arch resnet20 --steps 0 --plan-out BASE
    python -m repro_torch export --plan-in BASE --plan-out BASE2
    python -m repro_torch serve  --plan-in BASE [--device cpu]
    python -m repro_torch compress --target lm --reduced --compress-k 4
    python -m repro_torch serve  --plan-in LM_BASE [--verify-oneshot]
    python -m repro_torch serve  --plan-in LM_BASE --plans k4 base
    python -m repro_torch.launch.train --arch olmo-1b --steps 50 \
        --plan-out BASE [--ckpt-dir DIR]
"""

__version__ = "0.2.0"
