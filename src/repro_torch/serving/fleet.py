"""Multi-plan fleet serving: SLO-aware routing across compression levels
(port of `repro.serving.fleet`).

* `PlanHandle` — one serving variant: a comp tree (codebook restriction +
  optional MSR truncation) plus the identity the serving stack keys on. The
  identity is a **content fingerprint** hashing the codebook values, masks,
  ``msr_bits`` and the schedule's decision set — not the bare
  ``compress_k`` integer, which collides for two plans with equal k but
  different codebooks or MSR settings (`comp_fingerprint`).
* `PlanRegistry` — N resident handles per architecture, deduplicated by
  fingerprint; `PlanRegistry.from_dir` loads every saved `CompressionPlan`
  (``<base>.json`` + ``<base>.npz``, either package's) in a directory.
* `FleetRouter` — an admission layer over one `ServingEngine` per handle.
  Each submitted `ServeRequest` is routed to a *fidelity level* (handles
  sorted by measured per-token energy, highest first) from

    - **queue pressure**: pending requests across the fleet over the slot
      capacity (``max_batch * max_waves``). Above ``high_watermark`` the
      router steps one level toward aggressive compression; below
      ``low_watermark`` it steps back toward high fidelity. A level change
      needs ``hysteresis`` *consecutive* same-direction observations, so a
      noisy queue cannot flap the fleet between plans step to step.
    - **per-request budget**: ``ServeRequest.budget.energy_eu_per_token``
      caps the variant's measured energy; the router picks the first level
      at or below the cap (never a *less* compressed level than pressure
      already selected). An unsatisfiable budget routes to the most
      aggressive plan anyway — requests are never rejected — and records
      the SLO miss.

  Accounting is per tenant (requests, tokens, energy-units, SLO hit-rate)
  and per plan, both summing exactly to the fleet totals; `route_log` keeps
  every admission decision so degrade/recover transitions are auditable.

Engines are drained with interleaved scheduler steps (`ServingEngine.step`),
so one busy variant does not head-of-line block another's first token.
Every engine is the port's (its forward `QuantConfig.batch_invariant`), so
a routed request's tokens are those an engine pinned to its plan gives it,
in any mode. The routing decisions are a function of the submit sequence
and the engines' pending counts alone, so they equal the JAX package's for
the same trace.

The fingerprint hashes the same bytes in the same order as the JAX
package's (dtype string, shape string, then the contiguous bytes of each
leaf, dict keys sorted), so a comp tree has one fingerprint in both
packages. ``FleetRouter(mesh=)`` hands a request mesh
(`repro_torch.distributed.sharding.request_mesh`) to each of its engines,
as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE

__all__ = [
    "PlanHandle",
    "PlanRegistry",
    "RouterConfig",
    "FleetRouter",
    "comp_fingerprint",
]


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


# ----------------------------------------------------------------- registry


class PlanRegistry:
    """Resident serving variants for one architecture, deduped by content.

    Registering a handle whose fingerprint is already resident returns the
    existing handle (same weights -> same built steps; there is nothing new
    to serve). Registering a *different* plan under a taken ``plan_id``
    raises — ids are the human names routing reports use.
    """

    def __init__(self, handles: Sequence[PlanHandle] = ()):
        self._by_id: Dict[str, PlanHandle] = {}
        self._by_fp: Dict[str, PlanHandle] = {}
        for h in handles:
            self.register(h)

    def register(self, handle: PlanHandle) -> PlanHandle:
        existing = self._by_fp.get(handle.fingerprint)
        if existing is not None:
            return existing
        if handle.plan_id in self._by_id:
            raise ValueError(
                f"plan_id {handle.plan_id!r} already registered with a "
                f"different fingerprint "
                f"({self._by_id[handle.plan_id].fingerprint} != "
                f"{handle.fingerprint})")
        self._by_id[handle.plan_id] = handle
        self._by_fp[handle.fingerprint] = handle
        return handle

    def get(self, plan_id: str) -> PlanHandle:
        if plan_id not in self._by_id:
            raise KeyError(f"unknown plan_id {plan_id!r}; resident: "
                           f"{sorted(self._by_id)}")
        return self._by_id[plan_id]

    def handles(self) -> List[PlanHandle]:
        return list(self._by_id.values())

    def __len__(self) -> int:
        return len(self._by_id)

    def __iter__(self):
        return iter(self._by_id.values())

    def __contains__(self, plan_id: str) -> bool:
        return plan_id in self._by_id

    @classmethod
    def from_dir(cls, path, *, include_uncompressed: bool = False
                 ) -> "PlanRegistry":
        """Load every saved `CompressionPlan` (``<base>.json`` +
        ``<base>.npz``) under ``path`` into a registry. Plan ids are the
        file stems; ``include_uncompressed`` adds a k=0 handle so the fleet
        always holds a full-fidelity fallback."""
        from pathlib import Path

        from repro_torch.pipeline.plan import CompressionPlan

        reg = cls()
        base_dir = Path(path)
        if not base_dir.is_dir():
            raise FileNotFoundError(f"plan registry dir {base_dir} not found")
        for json_path in sorted(base_dir.glob("*.json")):
            if not json_path.with_suffix(".npz").exists():
                continue
            plan = CompressionPlan.load(json_path)
            reg.register(PlanHandle.from_compression_plan(
                plan, plan_id=json_path.stem))
        if include_uncompressed:
            reg.register(PlanHandle.uncompressed())
        if not len(reg):
            raise ValueError(f"no CompressionPlan artifacts under {base_dir}")
        return reg


# ------------------------------------------------------------------- router


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Admission policy knobs (see module docstring for the mechanics)."""

    high_watermark: float = 0.75   # pressure above -> step toward aggressive
    low_watermark: float = 0.25    # pressure below -> step toward fidelity
    hysteresis: int = 2            # consecutive observations per level change

    def __post_init__(self):
        if not 0.0 <= self.low_watermark <= self.high_watermark:
            raise ValueError(
                f"need 0 <= low_watermark <= high_watermark, got "
                f"{self.low_watermark} / {self.high_watermark}")
        if self.hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {self.hysteresis}")


class FleetRouter:
    """One `ServingEngine` per resident plan + an SLO-aware admission layer,
    on one device (``"cuda"`` unless the caller asks for ``"cpu"``) or a
    request mesh (``mesh=``, passed to every engine).

    Levels are the handles sorted by measured per-token energy, *highest
    first* — level 0 is the high-fidelity default served when idle, the last
    level the most aggressive compression served under pressure.
    """

    def __init__(self, model, params,
                 plans: Union[PlanRegistry, Sequence[PlanHandle]], *,
                 mode: str = "engine", config=None,
                 router: RouterConfig = RouterConfig(),
                 arch: Optional[str] = None, mesh=None,
                 device=DEFAULT_DEVICE):
        from repro_torch.serving.bucketing import EngineConfig
        from repro_torch.serving.engine import ServingEngine

        if config is None:
            config = EngineConfig()
        self.registry = (plans if isinstance(plans, PlanRegistry)
                         else PlanRegistry(plans))
        if not len(self.registry):
            raise ValueError("fleet needs at least one resident plan")
        self.config = config
        self.router = router
        self.engines: Dict[str, Any] = {}
        for h in self.registry:
            self.engines[h.plan_id] = ServingEngine(
                model, params, mode=mode, config=config, plan=h, arch=arch,
                mesh=mesh, device=device)
        # measure any handle the plan metrics didn't already price — the
        # engine's lazy per-token energy is the same model the charge uses
        for h in self.registry:
            if h.energy_per_token is None:
                h.energy_per_token = self.engines[h.plan_id].per_token_energy_eu
        self.levels: List[PlanHandle] = sorted(
            self.registry.handles(),
            key=lambda h: (-float(h.energy_per_token), h.plan_id))
        self._level = 0
        self._high_streak = 0
        self._low_streak = 0
        self._warm_compiles: Optional[int] = None
        self.route_log: List[Dict[str, Any]] = []
        self._routes: Dict[int, Tuple[str, int]] = {}   # rid -> (plan, erid)
        self._slo_energy_miss: Dict[int, bool] = {}
        self._requests: Dict[int, Any] = {}             # rid -> ServeRequest
        self._next_rid = 0
        self.wall_s = 0.0

    # ------------------------------------------------------------- capacity

    @property
    def slot_capacity(self) -> int:
        return self.config.slot_capacity

    @property
    def pending(self) -> int:
        """Requests submitted but not yet finished, across the fleet."""
        return sum(e.pending for e in self.engines.values())

    @property
    def pressure(self) -> float:
        return self.pending / max(self.slot_capacity, 1)

    # -------------------------------------------------------------- warmup

    def warmup(self, shapes: Sequence[tuple]) -> dict:
        """Build every resident engine's step set; zero builds after this
        is the fleet gate."""
        stats = {pid: e.warmup(shapes) for pid, e in self.engines.items()}
        self._warm_compiles = self._compile_count()
        return stats

    def _compile_count(self) -> int:
        return sum(e.cache.compile_count for e in self.engines.values())

    @property
    def recompiles_after_warmup(self) -> int:
        if self._warm_compiles is None:
            return 0
        return self._compile_count() - self._warm_compiles

    # ------------------------------------------------------------ admission

    def _observe_pressure(self, pressure: float) -> None:
        """Hysteresis: a level moves only after ``hysteresis`` consecutive
        same-direction observations; anything else decays both streaks."""
        r = self.router
        if pressure > r.high_watermark and self._level < len(self.levels) - 1:
            self._high_streak += 1
            self._low_streak = 0
            if self._high_streak >= r.hysteresis:
                self._level += 1
                self._high_streak = 0
        elif pressure < r.low_watermark and self._level > 0:
            self._low_streak += 1
            self._high_streak = 0
            if self._low_streak >= r.hysteresis:
                self._level -= 1
                self._low_streak = 0
        else:
            self._high_streak = 0
            self._low_streak = 0

    def _budget_level(self, budget, base_level: int) -> Tuple[int, bool]:
        """First level at or past ``base_level`` whose measured energy fits
        the request's cap; (most aggressive, miss=True) when none does."""
        cap = getattr(budget, "energy_eu_per_token", None)
        if cap is None:
            return base_level, False
        for lvl in range(base_level, len(self.levels)):
            if float(self.levels[lvl].energy_per_token) <= float(cap):
                return lvl, False
        return len(self.levels) - 1, True

    def submit(self, request) -> int:
        """Route one `ServeRequest` to a resident plan; returns the fleet
        request id. Requests are never rejected: an unsatisfiable energy
        budget lands on the most aggressive plan with the SLO miss
        recorded."""
        pressure = self.pressure
        self._observe_pressure(pressure)
        level = self._level
        miss = False
        if request.budget is not None:
            level, miss = self._budget_level(request.budget, level)
        handle = self.levels[level]
        engine = self.engines[handle.plan_id]
        erid = engine.submit_request(request)
        rid = self._next_rid
        self._next_rid += 1
        self._routes[rid] = (handle.plan_id, erid)
        self._requests[rid] = request
        self._slo_energy_miss[rid] = miss
        self.route_log.append({
            "rid": rid,
            "plan_id": handle.plan_id,
            "level": level,
            "pressure": pressure,
            "tenant": request.tenant,
            "budget_miss": miss,
        })
        return rid

    # ----------------------------------------------------------------- run

    def run(self) -> Dict[int, Any]:
        """Drain every engine with interleaved scheduler steps; returns
        {fleet rid: ServeResult} for every request routed so far."""
        t0 = time.perf_counter()
        progressed = True
        while progressed:
            progressed = False
            for engine in self.engines.values():
                progressed = engine.step() or progressed
        self.wall_s += time.perf_counter() - t0
        out = {}
        for rid, (plan_id, erid) in self._routes.items():
            res = self.engines[plan_id].result(erid)
            if res is not None:
                out[rid] = res
        return out

    def serve(self, requests: Sequence[Any]) -> List[Any]:
        """Submit a batch of `ServeRequest`s and drain; results in order."""
        rids = [self.submit(r) for r in requests]
        out = self.run()
        return [out[rid] for rid in rids]

    # -------------------------------------------------------------- reports

    def _slo_hit(self, rid: int, stats) -> Optional[bool]:
        """SLO verdict for a budgeted request (None when no budget): the
        routed variant fit the energy cap and the measured latency fit
        ``latency_s`` when set."""
        req = self._requests[rid]
        if req.budget is None:
            return None
        if self._slo_energy_miss.get(rid):
            return False
        lat_cap = getattr(req.budget, "latency_s", None)
        if lat_cap is not None and stats.latency_s > float(lat_cap):
            return False
        return True

    def report(self) -> dict:
        """Fleet totals + per-plan and per-tenant breakdowns (both sum to
        the totals) + the observed level transitions."""
        from repro_torch.serving.metrics import summarize

        finished: List[Tuple[int, Any]] = []
        for rid, (plan_id, erid) in self._routes.items():
            res = self.engines[plan_id].result(erid)
            if res is not None:
                finished.append((rid, res))
        stats = [r.stats for _, r in finished]
        out = summarize(stats, self.wall_s)
        out["plans_resident"] = len(self.levels)
        out["recompiles_after_warmup"] = self.recompiles_after_warmup

        plans: Dict[str, dict] = {}
        for h in self.levels:
            eng = self.engines[h.plan_id]
            plans[h.plan_id] = {
                "level": self.levels.index(h),
                "compress_k": h.compress_k,
                "fingerprint": h.fingerprint,
                "energy_eu_per_token_plan": float(h.energy_per_token),
                "requests": 0, "new_tokens": 0, "energy_eu": 0.0,
                "compile_count": eng.cache.compile_count,
            }
        tenants: Dict[str, dict] = {}
        for rid, res in finished:
            s = res.stats
            p = plans[s.plan_id]
            p["requests"] += 1
            p["new_tokens"] += s.new_tokens
            p["energy_eu"] += s.energy_eu
            t = tenants.setdefault(s.tenant, {
                "requests": 0, "new_tokens": 0, "energy_eu": 0.0,
                "slo_total": 0, "slo_hits": 0})
            t["requests"] += 1
            t["new_tokens"] += s.new_tokens
            t["energy_eu"] += s.energy_eu
            hit = self._slo_hit(rid, s)
            if hit is not None:
                t["slo_total"] += 1
                t["slo_hits"] += int(hit)
        for t in tenants.values():
            t["slo_hit_rate"] = (t["slo_hits"] / t["slo_total"]
                                 if t["slo_total"] else 1.0)
        out["plans"] = plans
        out["tenants"] = tenants
        out["slo_total"] = sum(t["slo_total"] for t in tenants.values())
        out["slo_hits"] = sum(t["slo_hits"] for t in tenants.values())

        levels = [e["level"] for e in self.route_log]
        out["level_degrades"] = sum(
            1 for a, b in zip(levels, levels[1:]) if b > a)
        out["level_recovers"] = sum(
            1 for a, b in zip(levels, levels[1:]) if b < a)
        return out
