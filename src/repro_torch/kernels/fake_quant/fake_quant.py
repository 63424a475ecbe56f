"""Build, load and launch the CUDA weight fake-quant kernel (K3,
``csrc/fake_quant.cu``).

The kernel replaces the TPU kernel
``repro.kernels.fake_quant.fake_quant.fake_quant_pallas`` and fuses the
most-significant-run truncation of `repro_torch.core.qat.fake_quant_weight`
between its rounding and its projection; the source's header says what
bounds it on an H100 and how its design responds.

The source compiles at first use with ``nvcc`` for ``sm_90a`` into
``build/fake_quant/`` at the repository root and is loaded with `ctypes`
(`repro_torch.kernels._build`). Nothing here runs at import.

``launches`` counts kernel launches (one per `launch` call that reached the
device), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "fake_quant.cu"
LIBRARY = KernelLibrary(
    "fake_quant", SOURCE,
    {"fake_quant_launch": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6})

launches = 0       # kernel launches in this process


def _scalar(v):
    """(device pointer or None, host value) of a k / msr_bits argument: a
    tensor is read by the kernel on the device (no host sync), an int is
    passed by value."""
    if isinstance(v, torch.Tensor):
        return v.data_ptr(), 0
    return None, int(v)


def launch(w: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
           codebook: torch.Tensor, k, msr_bits=0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors already validated by
    `repro_torch.kernels.fake_quant.ops.check_inputs` (use
    `repro_torch.kernels.fake_quant.ops.fake_quant_project`). Returns the
    float32 (M, N) output; raises `RuntimeError` if the launch failed."""
    global launches
    if w.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {w.device}")
    m, n = w.shape
    out = torch.empty((m, n), dtype=torch.float32, device=w.device)
    if m == 0 or n == 0:
        return out
    k_ptr, k_val = _scalar(k)
    msr_ptr, msr_val = _scalar(msr_bits)
    lib = LIBRARY.load()
    err = lib.fake_quant_launch(
        w.data_ptr(), mask.data_ptr(), scale.data_ptr(), codebook.data_ptr(),
        k_ptr, msr_ptr, out.data_ptr(),
        torch.cuda.current_stream(w.device).cuda_stream, w.device.index or 0,
        m, n, int(mask.dtype == torch.int8), k_val, msr_val)
    if err != 0:
        raise RuntimeError(f"fake_quant kernel launch failed: CUDA error {err} "
                           f"at M={m} N={n}")
    launches += 1
    return out
