"""Build, load and launch the CUDA weight fake-quant kernel (K3,
``csrc/fake_quant.cu``).

The kernel replaces the TPU kernel
``repro.kernels.fake_quant.fake_quant.fake_quant_pallas`` and fuses the
most-significant-run truncation of `repro_torch.core.qat.fake_quant_weight`
between its rounding and its projection; the source's header says what
bounds it on an H100 and how its design responds. `launch` runs one layer
with a caller-supplied scale; `launch_group` runs a whole QAT forward's
layers in one launch, with the per-column scale and the straight-through
value computed inside, and with a candidate axis all candidates of those
layers (the batched schedule sweep's forwards) in that same launch.

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
ENTRY_WORDS = 12   # int64 words of one grouped entry (see the source)

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


def _leaf(v, ndim, cands):
    """(device pointer or 0, value by value, shared by every candidate) of a
    comp leaf whose one-candidate form has ``ndim`` dims: an int is passed
    by value; a tensor with a leading candidate axis is shared where its
    stride there is 0."""
    if not isinstance(v, torch.Tensor):
        return 0, int(v), True
    stacked = cands is not None and v.ndim == ndim + 1
    return v.data_ptr(), 0, not stacked or v.stride(0) == 0


def launch_group(ws, comps, cands=None):
    """Launch the grouped kernel on CUDA layers already validated by
    `repro_torch.kernels.fake_quant.ops.check_group`: ``ws[i]`` float32 of
    any shape (the last axis is the output channel), ``comps[i]`` its
    compression state (``mask``, ``codebook``, ``codebook_k`` and an
    optional ``msr_bits``); with ``cands=n``, ``ws[i]`` is ``(n, *shape)``
    and each leaf carries that axis or is shared (``ops.candidate_leaf``);
    ``cands`` a sequence: one count (or None) an entry. Returns the
    straight-through forward values, ``wm + (wq - wm)``, one float32 tensor of ``ws[i]``'s shape each (contiguous); one launch per
    `group_capacity` layers, whatever the number of candidates. Raises
    `RuntimeError` if a launch failed."""
    global launches
    dev = ws[0].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    outs, words = [], []
    per_entry = (cands if isinstance(cands, (list, tuple))
                 else [cands] * len(ws))
    for w, comp, n_c in zip(ws, comps, per_entry, strict=True):
        base = w.ndim - (n_c is not None)
        n = w.shape[-1]
        mask = comp["mask"]
        w_ptr, _, w_shared = _leaf(w, base, n_c)
        m_ptr, _, m_shared = _leaf(mask, base, n_c)
        cb_ptr, _, cb_shared = _leaf(comp["codebook"], 1, n_c)
        k_ptr, k_val, k_shared = _leaf(comp["codebook_k"], 0, n_c)
        msr_ptr, msr_val, msr_shared = _leaf(comp.get("msr_bits", 0), 0,
                                             n_c)
        out = torch.empty_like(w, memory_format=torch.contiguous_format)
        bits = (int(mask.dtype == torch.int8) | w_shared << 1
                | m_shared << 2 | cb_shared << 3 | k_shared << 4
                | msr_shared << 5)
        per_cand = out[0].numel() if n_c is not None else out.numel()
        words.append((w_ptr, m_ptr, cb_ptr, k_ptr, msr_ptr, out.data_ptr(),
                      per_cand // n, n, bits, k_val, msr_val, n_c or 1))
        outs.append(out)
    lib = LIBRARY.load()
    cap = group_capacity()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    for i in range(0, len(words), cap):
        group = words[i:i + cap]
        table = (ctypes.c_longlong * (len(group) * ENTRY_WORDS))(
            *(v for entry in group for v in entry))
        err = lib.fake_quant_group_launch(table, len(group), stream,
                                          dev.index)
        if err != 0:
            raise RuntimeError(f"fake_quant group launch failed: CUDA error "
                               f"{err} at {len(group)} layers x "
                               f"{[e[11] for e in group]} candidates")
        launches += 1
    return outs


@functools.cache
def group_capacity() -> int:
    """Layers one grouped launch takes (the kernel's parameter table)."""
    return LIBRARY.load().fake_quant_group_capacity()
