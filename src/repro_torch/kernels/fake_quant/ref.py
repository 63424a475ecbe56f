"""Plain PyTorch version of the fused weight fake-quant (K3).

Port of `repro.kernels.fake_quant.ref` plus the most-significant-run (MSR)
truncation that `repro.core.qat.fake_quant_weight` applies between the
rounding and the projection: the same chain as the QAT path, with the
per-column scale supplied by the caller (the kernel's contract). The CPU
path of `repro_torch.kernels.fake_quant.ops` runs it, and the on-card check
holds the CUDA kernel against it on the same inputs.
"""

from __future__ import annotations

import torch

from repro_torch.core import qat


def fake_quant_ref(w: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
                   codebook: torch.Tensor, k, msr_bits=0) -> torch.Tensor:
    """``clip(round(w * mask / scale), +-127)`` -> MSR truncation to
    ``msr_bits`` (0 = off) -> nearest of the first ``k`` codebook values
    (0 = no projection) -> ``* scale``. w, mask (M, N); scale (N,)."""
    wm = w.float() * mask.float()
    q = torch.clamp(torch.round(wm / scale[None, :]), -qat.QMAX, qat.QMAX)
    qi = qat.msr_truncate_int(q.to(torch.int32), msr_bits)
    qi = qat.project_to_codebook(qi, codebook, k)
    return (qi.float() * scale[None, :]).to(w.dtype)
