"""Plain PyTorch version of the fused weight fake-quant (K3).

Port of `repro.kernels.fake_quant.ref` plus the most-significant-run (MSR)
truncation that `repro.core.qat.fake_quant_weight` applies between the
rounding and the projection: the same chain as the QAT path, with the
per-column scale supplied by the caller (the per-layer kernel's contract),
and `fake_quant_ste_ref`, one layer of the grouped kernel: the scale and the
straight-through value around that chain. The CPU path of
`repro_torch.kernels.fake_quant.ops` runs them, and the on-card check holds
the CUDA kernels against them on the same inputs.
"""

from __future__ import annotations

import torch

from repro_torch.core import qat

# ndim of each comp leaf of one layer without a candidate axis ("mask": the
# weight's)
_LEAF_NDIM = {"codebook": 1, "codebook_k": 0, "msr_bits": 0}


def fake_quant_ref(w: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
                   codebook: torch.Tensor, k, msr_bits=0) -> torch.Tensor:
    """``clip(round(w * mask / scale), +-127)`` -> MSR truncation to
    ``msr_bits`` (0 = off) -> nearest of the first ``k`` codebook values
    (0 = no projection) -> ``* scale``. w, mask (M, N); scale (N,)."""
    wm = w.float() * mask.float()
    q = torch.clamp(torch.round(wm / scale[None, :]), -qat.QMAX, qat.QMAX)
    qi = qat.msr_truncate_int(qat.clipped_to_int(q), msr_bits)
    qi = qat.project_to_codebook(qi, codebook, k)
    return (qi.float() * scale[None, :]).to(w.dtype)


def fake_quant_ste_ref(w: torch.Tensor, comp) -> torch.Tensor:
    """The straight-through forward value of `qat.fake_quant_weight`,
    ``wm + (wq - wm)``, with ``wm = w * mask``, ``wq`` `fake_quant_ref` at
    the per-output-channel scale of ``wm``. ``w`` of any shape, its last
    axis the output channel; ``comp`` a `qat.CompState` (``msr_bits``
    optional)."""
    n = w.shape[-1]
    w2, mask2 = w.reshape(-1, n), comp["mask"].reshape(-1, n)
    wm = w2 * mask2.to(w.dtype)
    wq = fake_quant_ref(w2, mask2, qat.weight_scale(wm).reshape(-1),
                        comp["codebook"], comp["codebook_k"],
                        comp.get("msr_bits", 0))
    return (wm + (wq - wm)).reshape(w.shape)


def candidate_comp(comp, w_ndim: int, j: int):
    """Candidate ``j``'s comp state of a layer under a candidate axis: a
    leaf with a leading candidate axis gives its slice ``j``, a shared leaf
    (one without that axis, or an int) itself. ``w_ndim``: the ndim of the
    layer's weight without the candidate axis."""
    out = {}
    for key, v in comp.items():
        ndim = w_ndim if key == "mask" else _LEAF_NDIM[key]
        out[key] = (v[j] if isinstance(v, torch.Tensor) and v.ndim == ndim + 1
                    else v)
    return out


def fake_quant_group_ref(ws, comps, cands=None) -> list:
    """The grouped kernel's function: `fake_quant_ste_ref` of every layer,
    and with ``cands=n`` of every candidate ``j`` of every layer
    (``ws[i][j]`` under `candidate_comp`), stacked back along the candidate
    axis. ``cands`` may give one count (or None) an entry."""
    if cands is None or isinstance(cands, int):
        cands = [cands] * len(ws)
    return [fake_quant_ste_ref(w, c) if n is None else
            torch.stack([fake_quant_ste_ref(w[j],
                                            candidate_comp(c, w.ndim - 1, j))
                         for j in range(n)])
            for w, c, n in zip(ws, comps, cands, strict=True)]
