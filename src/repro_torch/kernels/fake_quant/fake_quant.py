"""Build, load and launch the CUDA weight fake-quant kernel (K3,
``csrc/fake_quant.cu``).

The kernel replaces the TPU kernel
``repro.kernels.fake_quant.fake_quant.fake_quant_pallas`` and fuses the
most-significant-run truncation of `repro_torch.core.qat.fake_quant_weight`
between its rounding and its projection; the source's header says what
bounds it on an H100 and how its design responds. `launch` runs one layer
with a caller-supplied scale; `launch_group` runs a whole QAT forward's
layers in one launch, with the per-column scale and the straight-through
value computed inside.

The source compiles at first use with ``nvcc`` for ``sm_90a`` into
``build/fake_quant/`` at the repository root and is loaded with `ctypes`
(`repro_torch.kernels._build`). Nothing here runs at import.

``launches`` counts kernel launches (one per `launch` call, and one per
group of at most the kernel's capacity in a `launch_group` call, that
reached the device), so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "fake_quant.cu"
LIBRARY = KernelLibrary(
    "fake_quant", SOURCE,
    {"fake_quant_launch": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6,
     "fake_quant_group_launch": [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int],
     "fake_quant_group_capacity": []})

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


def launch_group(ws, comps):
    """Launch the grouped kernel on CUDA layers already validated by
    `repro_torch.kernels.fake_quant.ops.check_group`: ``ws[i]`` float32 of
    any shape (the last axis is the output channel), ``comps[i]`` its
    compression state (``mask``, ``codebook``, ``codebook_k`` and an
    optional ``msr_bits``). Returns the straight-through forward values,
    ``wm + (wq - wm)``, one float32 tensor of ``ws[i]``'s shape each; one
    launch per `group_capacity` layers. Raises `RuntimeError` if a launch
    failed."""
    global launches
    dev = ws[0].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    outs, words = [], []
    for w, comp in zip(ws, comps):
        n = w.shape[-1]
        mask = comp["mask"]
        k_ptr, k_val = _scalar(comp["codebook_k"])
        msr_ptr, msr_val = _scalar(comp.get("msr_bits", 0))
        out = torch.empty_like(w)
        words.append((w.data_ptr(), mask.data_ptr(),
                       comp["codebook"].data_ptr(), k_ptr or 0, msr_ptr or 0,
                       out.data_ptr(), w.numel() // n, n,
                       int(mask.dtype == torch.int8), k_val, msr_val))
        outs.append(out)
    lib = LIBRARY.load()
    cap = group_capacity()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    for i in range(0, len(words), cap):
        group = words[i:i + cap]
        table = (ctypes.c_longlong * (len(group) * len(group[0])))(
            *(v for entry in group for v in entry))
        err = lib.fake_quant_group_launch(table, len(group), stream,
                                          dev.index)
        if err != 0:
            raise RuntimeError(f"fake_quant group launch failed: CUDA error "
                               f"{err} at {len(group)} layers")
        launches += 1
    return outs


@functools.cache
def group_capacity() -> int:
    """Layers one grouped launch takes (the kernel's parameter table)."""
    return LIBRARY.load().fake_quant_group_capacity()
