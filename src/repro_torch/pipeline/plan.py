"""`CompressionPlan`: the one artifact every pipeline stage reads and writes.

Port of `repro.pipeline.plan` with the identical on-disk encoding:
``save(base)`` writes ``<base>.json`` (structure + static fields) and
``<base>.npz`` (the array payload); ``CompressionPlan.load(base)`` reads
either package's plans. Arrays load as CPU tensors of the stored dtype
(bfloat16 leaves are stored widened to float32 with a dtype tag and come
back as `torch.bfloat16`); `Pipeline` moves them to its device.

Array sections and the stage that fills them:

  section     stage          contents
  ---------   ------------   -------------------------------------------
  params      profile        model parameters after QAT base training
  state       profile        non-trainable state (CNN batch stats)
  opt_state   profile        optimizer moments
  comp        profile        per-layer CompState {mask, codebook, ...}
  stats       profile        {layer: LayerStats} systolic trace statistics
  luts        energy_model   {layer: (256,) blended per-weight-value LUT}
  artifacts   export         {layer/unit: ServeArtifact} packed 4-bit form
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.export import ServeArtifact
from repro_torch.core.stats import LayerStats
from repro_torch.pipeline.schema import PLAN_FORMAT, PLAN_SCHEMA_VERSION, STAGES

ARRAY_SECTIONS = ("params", "state", "opt_state", "comp", "stats", "luts",
                  "artifacts")


@dataclasses.dataclass
class CompressionPlan:
    """Everything the pipeline has learned about one model so far."""

    schema_version: int = PLAN_SCHEMA_VERSION
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    target: Dict[str, Any] = dataclasses.field(default_factory=dict)
    completed: Tuple[str, ...] = ()
    decisions: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    shares: Dict[str, float] = dataclasses.field(default_factory=dict)

    params: Any = None
    state: Any = None
    opt_state: Any = None
    comp: Any = None
    stats: Any = None
    luts: Any = None
    artifacts: Any = None

    # ---------------------------------------------------------------- stages

    def is_done(self, stage: str) -> bool:
        return stage in self.completed

    def mark_done(self, stage: str) -> None:
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}")
        if stage not in self.completed:
            self.completed = tuple(s for s in STAGES
                                   if s in self.completed or s == stage)

    # ------------------------------------------------------------ fingerprint

    def fingerprint(self) -> str:
        """Content identity of the plan's *serving-relevant* state: the comp
        tree (codebook values, masks, ``msr_bits``) plus the schedule's
        decision set; what `repro_torch.serving.ServeCompileCache` keys
        steps and exported artifacts on. Equal to the JAX package's
        fingerprint of the same plan."""
        from repro_torch.serving.fleet import comp_fingerprint

        extra = json.dumps(self.decisions, sort_keys=True) \
            if self.decisions else None
        return comp_fingerprint(self.comp, extra=extra)

    # --------------------------------------------------------------- summary

    def summary(self) -> Dict[str, Any]:
        out = {
            "target": dict(self.target),
            "completed": list(self.completed),
            "metrics": {k: (round(v, 4) if isinstance(v, float) else v)
                        for k, v in self.metrics.items()},
        }
        if self.decisions:
            out["layers"] = [
                {"layer": d["layer"], "share": round(d["share"], 4),
                 "prune": d["prune_ratio"], "k": d["k"],
                 "msr": d.get("msr"), "accepted": d["accepted"]}
                for d in self.decisions
            ]
        if self.artifacts:
            out["exported_units"] = len(self.artifacts)
        return out

    # ------------------------------------------------------------- save/load

    def save(self, base) -> Tuple[Path, Path]:
        """Write ``<base>.json`` + ``<base>.npz``; returns both paths."""
        base = _strip_ext(base)
        arrays: Dict[str, np.ndarray] = {}
        tree = {s: _encode(getattr(self, s), arrays)
                for s in ARRAY_SECTIONS if getattr(self, s) is not None}
        doc = {
            "format": PLAN_FORMAT,
            "schema_version": self.schema_version,
            "config": self.config,
            "target": self.target,
            "completed": list(self.completed),
            "decisions": self.decisions,
            "metrics": self.metrics,
            "shares": self.shares,
            "tree": tree,
            "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in arrays.items()},
        }
        json_path = base.with_suffix(".json")
        npz_path = base.with_suffix(".npz")
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(json.dumps(doc, indent=1, sort_keys=False))
        np.savez(npz_path, **arrays)
        return json_path, npz_path

    @classmethod
    def load(cls, base) -> "CompressionPlan":
        base = _strip_ext(base)
        doc = json.loads(base.with_suffix(".json").read_text())
        if doc.get("format") != PLAN_FORMAT:
            raise ValueError(f"{base}: not a {PLAN_FORMAT} document")
        if doc.get("schema_version") != PLAN_SCHEMA_VERSION:
            raise ValueError(
                f"{base}: plan schema v{doc.get('schema_version')} != "
                f"supported v{PLAN_SCHEMA_VERSION}")
        with np.load(base.with_suffix(".npz")) as npz:
            arrays = {k: npz[k] for k in npz.files}
        plan = cls(
            schema_version=doc["schema_version"],
            config=doc.get("config", {}),
            target=doc.get("target", {}),
            completed=tuple(doc.get("completed", [])),
            decisions=list(doc.get("decisions", [])),
            metrics=dict(doc.get("metrics", {})),
            shares=dict(doc.get("shares", {})),
        )
        for section, node in doc.get("tree", {}).items():
            setattr(plan, section, _decode(node, arrays))
        return plan


# ------------------------------------------------------- structure encoding


def _strip_ext(base) -> Path:
    base = Path(base)
    if base.suffix in (".json", ".npz"):
        base = base.with_suffix("")
    return base


def _to_numpy(obj) -> Tuple[np.ndarray, str]:
    """Array leaf -> (storable numpy array, dtype tag)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:  # np.savez can't store bfloat16
            return t.float().numpy(), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(obj)
    dtype = str(a.dtype)
    return (a.astype(np.float32) if dtype == "bfloat16" else a), dtype


def _encode(obj, arrays: Dict[str, np.ndarray]):
    """Structure -> JSON-serializable node; arrays land in ``arrays``."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        a, dtype = _to_numpy(obj)
        key = f"a{len(arrays):05d}"
        arrays[key] = a
        return {"__array__": key, "dtype": dtype}
    if isinstance(obj, LayerStats):
        return {"__layerstats__": {
            "act_hist": _encode(obj.act_hist, arrays),
            "group_hist": _encode(obj.group_hist, arrays),
            "energy_sum": _encode(obj.energy_sum, arrays),
            "count": _encode(obj.count, arrays),
            "n_transitions": int(obj.n_transitions),
        }}
    if isinstance(obj, ServeArtifact):
        return {"__artifact__": {
            "packed": _encode(obj.packed, arrays),
            "codebook": _encode(obj.codebook, arrays),
            "scale": _encode(obj.scale, arrays),
            "k_dim": int(obj.k_dim), "n_dim": int(obj.n_dim),
            "block_k": int(obj.block_k), "kind": obj.kind,
            "kernel": int(obj.kernel),
        }}
    if isinstance(obj, dict):
        return {"__dict__": {str(k): _encode(v, arrays)
                             for k, v in obj.items()}}
    if isinstance(obj, tuple):
        return {"__tuple__": [_encode(v, arrays) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v, arrays) for v in obj]
    raise TypeError(
        f"CompressionPlan cannot serialize {type(obj).__name__}; supported "
        f"node types are dict/list/tuple/tensor/array/scalar/"
        f"LayerStats/ServeArtifact")


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    # np.array, not np.ascontiguousarray: the latter makes 0-d arrays (an
    # optimizer step, a codebook size) 1-d
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a.astype(dtype, copy=False)))


def _decode(node, arrays: Dict[str, np.ndarray]):
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if isinstance(node, list):
        return [_decode(v, arrays) for v in node]
    if "__array__" in node:
        return _tensor(arrays[node["__array__"]], node["dtype"])
    if "__layerstats__" in node:
        d = node["__layerstats__"]
        return LayerStats(
            act_hist=_decode(d["act_hist"], arrays),
            group_hist=_decode(d["group_hist"], arrays),
            energy_sum=_decode(d["energy_sum"], arrays),
            count=_decode(d["count"], arrays),
            n_transitions=int(d["n_transitions"]),
        )
    if "__artifact__" in node:
        d = node["__artifact__"]
        return ServeArtifact(
            packed=_decode(d["packed"], arrays),
            codebook=_decode(d["codebook"], arrays),
            scale=_decode(d["scale"], arrays),
            k_dim=d["k_dim"], n_dim=d["n_dim"], block_k=d["block_k"],
            kind=d["kind"], kernel=d["kernel"],
        )
    if "__dict__" in node:
        return {k: _decode(v, arrays) for k, v in node["__dict__"].items()}
    if "__tuple__" in node:
        return tuple(_decode(v, arrays) for v in node["__tuple__"])
    raise ValueError(f"unrecognized plan node: {list(node)[:3]}")


def decision_dict(d) -> Dict[str, Any]:
    """`repro_torch.core.schedule.LayerDecision` -> plain serializable dict
    (the JAX package's plan encoding of a decision)."""
    return {
        "layer": d.layer,
        "share": float(d.share),
        "prune_ratio": None if d.prune_ratio is None else float(d.prune_ratio),
        "k": None if d.k is None else int(d.k),
        "energy_before": float(d.energy_before),
        "energy_after": float(d.energy_after),
        "accuracy": float(d.accuracy),
        "accepted": bool(d.accepted),
        "msr": None if d.msr is None else int(d.msr),
        "tried": [[float(t[0]), int(t[1])] + ([int(t[2])] if len(t) > 2
                                               else [])
                  for t in d.tried],
    }
