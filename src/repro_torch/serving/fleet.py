"""Serving-variant identity (port of the identity part of
`repro.serving.fleet`).

* `PlanHandle` — one serving variant: a comp tree (codebook restriction +
  optional MSR truncation) plus the identity the serving stack keys on. The
  identity is a **content fingerprint** hashing the codebook values, masks,
  ``msr_bits`` and the schedule's decision set — not the bare
  ``compress_k`` integer, which collides for two plans with equal k but
  different codebooks or MSR settings (`comp_fingerprint`).

The fingerprint hashes the same bytes in the same order as the JAX
package's (dtype string, shape string, then the contiguous bytes of each
leaf, dict keys sorted), so a comp tree has one fingerprint in both
packages. The fleet router (`PlanRegistry`, `RouterConfig`, `FleetRouter`)
is not ported yet (`FLEET_NOT_PORTED`).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE

__all__ = ["PlanHandle", "comp_fingerprint"]

FLEET_NOT_PORTED = ("ROADMAP.md Queue 1 item 7, 'Serving' (fleet: "
                    "PlanRegistry, RouterConfig, FleetRouter)")


# ------------------------------------------------------------- fingerprints


def _leaf_array(node):
    """(dtype string, numpy array) of a tensor or array leaf, on the CPU;
    bfloat16 tensors hash their raw 16-bit words under the JAX package's
    dtype name."""
    if isinstance(node, torch.Tensor):
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy()
        a = t.numpy()
        return str(a.dtype), a
    a = np.asarray(node)
    return str(a.dtype), a


def _hash_node(h, node) -> None:
    """Feed one comp-tree node into the hash, order-independent of dict
    insertion (keys are sorted) and exact on array contents + dtype."""
    if node is None:
        h.update(b"\x00none")
    elif isinstance(node, (bool, int, float, str)):
        h.update(repr(node).encode())
    elif isinstance(node, dict):
        for k in sorted(node, key=str):
            if k == "serve":
                # packed ServeArtifacts (lm_compress.attach_serve_artifacts)
                # are *derived* from the other leaves — hashing them would
                # make a plan's identity depend on whether artifacts were
                # attached yet
                continue
            h.update(str(k).encode())
            _hash_node(h, node[k])
    elif isinstance(node, (list, tuple)):
        h.update(f"\x00seq{len(node)}".encode())
        for v in node:
            _hash_node(h, v)
    else:
        dtype, a = _leaf_array(node)
        h.update(dtype.encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())


def comp_fingerprint(comp, extra: Optional[str] = None) -> str:
    """Content hash of a comp tree (masks, codebook values, ``codebook_k``,
    ``msr_bits`` — every leaf) plus an optional ``extra`` string (e.g. the
    schedule's serialized decision set). Two plans that serve different
    weights can never share a fingerprint; ``comp=None`` hashes to a
    distinguished uncompressed identity."""
    h = hashlib.blake2b(digest_size=8)
    if comp is None:
        h.update(b"uncompressed")
    else:
        _hash_node(h, comp)
    if extra:
        h.update(b"\x00extra")
        h.update(extra.encode())
    return h.hexdigest()


# ------------------------------------------------------------- plan handles


@dataclasses.dataclass
class PlanHandle:
    """One serving variant: comp tree + content identity + measured scores.

    ``energy_per_token`` (eu, `repro_torch.serving.metrics.per_token_energy`)
    and ``accuracy_score`` come from plan metrics when loaded from a
    `CompressionPlan`. ``compress_k`` is kept for reporting only — the
    serving stack keys on ``fingerprint``.
    """

    plan_id: str
    comp: Any = None
    compress_k: int = 0
    msr_bits: int = 0
    fingerprint: str = ""
    energy_per_token: Optional[float] = None
    accuracy_score: Optional[float] = None
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.fingerprint:
            self.fingerprint = comp_fingerprint(self.comp)

    @property
    def compressed(self) -> bool:
        return self.comp is not None

    # -------------------------------------------------------- constructors

    @classmethod
    def uncompressed(cls, plan_id: str = "base") -> "PlanHandle":
        """The full-fidelity variant: no codebook restriction."""
        return cls(plan_id=plan_id, comp=None, compress_k=0)

    @classmethod
    def from_comp(cls, comp, *, compress_k: int = 0, plan_id: str = "custom",
                  **kw) -> "PlanHandle":
        """Wrap a pre-built comp tree (e.g. a schedule's mixed decisions)."""
        return cls(plan_id=plan_id, comp=comp, compress_k=int(compress_k),
                   **kw)

    @classmethod
    def from_compress_k(cls, model, k: int, *, msr_bits: int = 0,
                        plan_id: Optional[str] = None,
                        device=DEFAULT_DEVICE) -> "PlanHandle":
        """Uniform k-value codebook restriction over every eligible matmul,
        optionally with MSR truncation to ``msr_bits`` magnitude bits; the
        comp tree is made on ``device``."""
        from repro_torch.core import lm_compress

        k = int(k)
        if not k:
            return cls.uncompressed(plan_id or "base")
        comp = lm_compress.init_lm_comp(model, device=device)
        comp = lm_compress.restrict_all_codebooks(
            model, comp, lm_compress.symmetric_codebook_values(k))
        if msr_bits:
            comp = _with_msr_bits(comp, int(msr_bits))
        if plan_id is None:
            plan_id = f"k{k}" + (f"m{msr_bits}" if msr_bits else "")
        return cls(plan_id=plan_id, comp=comp, compress_k=k,
                   msr_bits=int(msr_bits))

    @classmethod
    def from_compression_plan(cls, plan,
                              plan_id: Optional[str] = None) -> "PlanHandle":
        """Adopt a `repro_torch.pipeline.CompressionPlan`: its comp tree, its
        fingerprint (codebooks + decisions), and its measured metrics."""
        m = plan.metrics
        if plan_id is None:
            arch = plan.target.get("name", plan.target.get("arch", "plan"))
            k = int(m.get("compress_k", 0) or 0)
            plan_id = f"{arch}-k{k}" if k else f"{arch}-base"
        acc = m.get("acc_final", m.get("serve_accuracy"))
        return cls(
            plan_id=plan_id,
            comp=plan.comp,
            compress_k=int(m.get("compress_k", 0) or 0),
            fingerprint=plan.fingerprint(),
            energy_per_token=(float(m["energy_after"])
                              if "energy_after" in m else None),
            accuracy_score=None if acc is None else float(acc),
            metrics={k_: v for k_, v in m.items()
                     if isinstance(v, (int, float, bool, str))},
        )


def _with_msr_bits(comp, msr_bits: int):
    """Return a comp tree whose per-unit entries carry ``msr_bits`` (read by
    `repro_torch.core.qat.quantize_weight_int` / `fake_quant_weights`)."""

    def walk(node):
        if isinstance(node, dict):
            if "codebook" in node:
                out = dict(node)
                out["msr_bits"] = int(msr_bits)
                return out
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(comp)
