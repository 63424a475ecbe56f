"""Build, load and launch the CUDA LUT-GEMM kernel (``csrc/lut_matmul.cu``).

The kernel replaces the TPU kernel
``repro.kernels.lut_matmul.lut_matmul.lut_matmul_pallas``; the source's
header says what bounds it on an H100 and how its design responds.

The source compiles at first use with ``nvcc`` for ``sm_90a`` into
``build/lut_matmul/`` at the repository root and is loaded with `ctypes`
(`repro_torch.kernels._build`). Nothing here runs at import: the CPU tests
import this module on hosts without ``nvcc`` or a GPU.

``launches`` counts kernel launches (one per `launch` call that reached the
device), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary
from repro_torch.kernels.lut_matmul.ref import N_CODES

# the keys of ref.ACTIVATIONS, coded as csrc's `activate` expects them
ACT_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}

SOURCE = Path(__file__).resolve().parent / "csrc" / "lut_matmul.cu"
LIBRARY = KernelLibrary(
    "lut_matmul", SOURCE,
    {"lut_matmul_launch": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7})

launches = 0       # kernel launches in this process


def check_inputs(x, packed, codebook, scale, bias, residual, activation,
                 pack_block) -> None:
    """Raise `ValueError` on anything the kernel does not take: the bad
    shapes of the TPU kernel's `_check_blocks`, plus device, dtype and
    contiguity (the kernel reads raw row-major memory, so a strided view is
    refused rather than copied behind the caller's back)."""
    if x.ndim != 2 or packed.ndim != 2:
        raise ValueError(f"x and packed must be 2-D, got {tuple(x.shape)} and "
                         f"{tuple(packed.shape)}")
    m, k = x.shape
    k2, n = packed.shape
    if k != 2 * k2:
        raise ValueError(
            f"packed shape {(k2, n)} does not pair with x shape {(m, k)}: "
            f"need K == 2 * packed rows, got K={k} vs {2 * k2}")
    if pack_block % 2 != 0 or pack_block < 2:
        raise ValueError(f"pack_block must be a positive even int, "
                         f"got {pack_block}")
    if k % pack_block:
        raise ValueError(
            f"K={k} must already be a multiple of pack_block={pack_block} "
            "(packing is block-local; pad K at export)")
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"expected one of {sorted(ACT_CODES)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    want = {"packed": (packed, torch.int8, (k2, n)),
            "codebook": (codebook, torch.int8, (N_CODES,)),
            "scale": (scale, torch.float32, (n,))}
    if bias is not None:
        want["bias"] = (bias, torch.float32, (n,))
    if residual is not None:
        want["residual"] = (residual, torch.float32, (m, n))
    for name, (t, dtype, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    for name, t in [("x", x)] + [(nm, v[0]) for nm, v in want.items()]:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous row-major; build it "
                             "contiguous (no strided views)")


def launch(x, packed, codebook, scale, *, bias=None, residual=None,
           activation: str = "none", pack_block: int = 128) -> torch.Tensor:
    """Launch the kernel on CUDA tensors already validated by `check_inputs`
    (use `repro_torch.kernels.lut_matmul.ops.lut_matmul_fused`). Returns the
    float32 (M, N) output; raises `RuntimeError` if the launch failed."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
    m, k = x.shape
    n = packed.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = LIBRARY.load()
    err = lib.lut_matmul_launch(
        x.data_ptr(), packed.data_ptr(), codebook.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        x.device.index or 0, m, k, n, pack_block, ACT_CODES[activation],
        int(x.dtype == torch.bfloat16))
    if err != 0:
        raise RuntimeError(f"lut_matmul kernel launch failed: CUDA error {err} "
                           f"at M={m} K={k} N={n}")
    launches += 1
    return out
