"""Routing and activity profiling for traffic-weighted unit compression (port
of `repro.core.routing_stats`).

For MoE and recurrent-scan LMs the energy prior of a unit is the measured
traffic through it: how often the router dispatches tokens to an expert,
and how much signal flows through each scan layer. This module collects
those statistics from calibration traces and turns them into per-unit
compression aggressiveness (hot experts keep gentler codebooks, cold ones
compress hard).

Mechanics: the MoE FFN and the scan mixers (`repro_torch.nn.moe`,
`repro_torch.nn.ssm`, `repro_torch.nn.rglru`) emit one event a call through
a collector contextvar, and do nothing while none is set (no host sync on
the main path). `collect_lm_routing_stats` drives `LMModel.prefill`, whose
layer walk is repeats, then pattern, then tail, as the JAX package's eager
prefill, and maps the event stream back onto named comp units
("blocks/g0/moe", the layer index within the stack).

The JAX package draws its calibration batches from a `jax.random` chain,
which torch cannot reproduce: `calibration_batches` draws them from
``np.random.default_rng``, and callers may pass their own batches (tests
feed both packages the same tokens).

Downstream everything is numpy: traffic shares normalize per layer, and
`assign_rank_k` buckets units by traffic rank onto a k ladder sorted
gentle to aggressive, which makes hot-gentler / cold-aggressive monotone by
construction.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Collector signature: fn(kind, name, value) with kind in {"moe", "ssm",
# "rglru"}, name the block-local comp prefix (e.g. "moe"), and value a
# per-call statistic tensor ((E,) kept-dispatch counts for MoE, a 0-d mean
# square activation for the scan mixers), still on the model's device.
_COLLECTOR: contextvars.ContextVar[Optional[Callable]] = \
    contextvars.ContextVar("routing_stats_collector", default=None)


def get_collector() -> Optional[Callable]:
    return _COLLECTOR.get()


def set_collector(fn: Optional[Callable]):
    """Returns a contextvars token; reset with the token when done."""
    return _COLLECTOR.set(fn)


@contextlib.contextmanager
def collecting(fn: Callable):
    token = set_collector(fn)
    try:
        yield
    finally:
        _COLLECTOR.reset(token)


def mean_square(x: torch.Tensor) -> torch.Tensor:
    """The scan mixers' calibration statistic: the mean of the float32
    squares of ``x``, summed in float64 and rounded once (0-d float32)."""
    x32 = x.float()
    return (x32 * x32).mean(dtype=torch.float64).float()


# ------------------------------------------------------------------ stats


@dataclasses.dataclass
class RoutingStats:
    """Accumulated calibration statistics, keyed by comp-unit base path.

    ``moe_counts["blocks/g0/moe"]`` is a (n_layers_in_stack, E) float64
    array of kept-dispatch token counts (capacity-dropped tokens excluded:
    they never reach the expert matmuls). ``scan_activity["blocks/g0/ssm"]``
    is (n_layers_in_stack,) mean-square pre-mixer activation. Tail
    (unstacked) units get a leading layer axis of 1."""

    moe_counts: Dict[str, np.ndarray]
    scan_activity: Dict[str, np.ndarray]
    tokens: int    # total calibration tokens seen (batches * batch * seq)

    def as_arrays(self) -> Dict[str, np.ndarray]:
        """Flat {key: array} form that round-trips through plan npz stores
        (the JAX package's keys: ``moe:<unit>``, ``scan:<unit>``,
        ``tokens``)."""
        out = {f"moe:{k}": v for k, v in self.moe_counts.items()}
        out.update({f"scan:{k}": v for k, v in self.scan_activity.items()})
        out["tokens"] = np.asarray(self.tokens, np.int64)
        return out

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray]) -> "RoutingStats":
        moe = {k[len("moe:"):]: _host(v) for k, v in arrays.items()
               if k.startswith("moe:")}
        scan = {k[len("scan:"):]: _host(v) for k, v in arrays.items()
                if k.startswith("scan:")}
        return cls(moe_counts=moe, scan_activity=scan,
                   tokens=int(_host(arrays.get("tokens", 0))))


def _host(v) -> np.ndarray:
    """A plan leaf (numpy, or a tensor on any device) as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _block_stat_kind(cfg, block_type: str) -> Optional[str]:
    """Which event (if any) one block of this type emits a forward call."""
    if block_type in ("attn", "local") and cfg.is_moe:
        return "moe"
    if block_type in ("ssm", "rglru"):
        return block_type
    return None


def expected_units(model) -> List[Tuple[str, str, Optional[int]]]:
    """Event schedule of one prefill: (unit_base, kind, layer_index).

    Mirrors `LMModel.prefill`'s walk: repeats outer, pattern inner, then
    tail blocks. layer_index is the repeat index within the stacked group
    (None for tail units, stored as layer 0)."""
    cfg = model.cfg
    out: List[Tuple[str, str, Optional[int]]] = []
    for r in range(model.n_rep):
        for i, bt in enumerate(cfg.pattern):
            kind = _block_stat_kind(cfg, bt)
            if kind is not None:
                out.append((f"blocks/g{i}/{kind}", kind, r))
    for j in range(model.n_tail):
        kind = _block_stat_kind(cfg, cfg.pattern[j])
        if kind is not None:
            out.append((f"tail/t{j}/{kind}", kind, None))
    return out


def calibration_batches(vocab: int, batches: int, batch_size: int,
                        seq_len: int, seed: int) -> List[np.ndarray]:
    """Deterministic synthetic token batches for routing calibration:
    batch i is ``np.random.default_rng([seed, i]).integers(0, vocab,
    (batch_size, seq_len))`` as int32 (the JAX package folds i into a
    ``jax.random`` key instead, which torch cannot reproduce)."""
    return [np.random.default_rng([seed, i]).integers(
        0, vocab, (batch_size, seq_len)).astype(np.int32)
        for i in range(batches)]


def collect_lm_routing_stats(model, params, *, comp=None, qcfg=None,
                             batches: int = 2, batch_size: int = 2,
                             seq_len: int = 32, seed: int = 0,
                             tokens: Optional[Iterable] = None
                             ) -> RoutingStats:
    """Profile routing and activity over calibration traces.

    Runs `model.prefill` per batch under an event collector and
    accumulates per-unit statistics; the events are pulled to the host
    here, one copy a batch. ``tokens``: the (B, S) int token batches to
    run (numpy or tensors); default `calibration_batches` of the other
    arguments. Deterministic: dispatch has no stochastic component."""
    from repro_torch.nn.layers import QuantConfig

    if qcfg is None:
        qcfg = QuantConfig.off()
    schedule = expected_units(model)
    if not schedule:
        raise ValueError(
            f"arch {model.cfg.name!r} has no MoE or scan units to profile")
    if tokens is None:
        tokens = calibration_batches(model.cfg.vocab, batches, batch_size,
                                     seq_len, seed)
    device = params["embed"]["table"].device

    n_rep = max(model.n_rep, 1)
    moe_counts: Dict[str, np.ndarray] = {}
    scan_sums: Dict[str, np.ndarray] = {}
    events: List[Tuple[str, str, torch.Tensor]] = []
    n_calls = tokens_total = 0

    def on_event(kind, name, value):
        events.append((kind, name, value))

    for toks in tokens:
        toks = torch.as_tensor(np.asarray(toks) if not isinstance(
            toks, torch.Tensor) else toks).to(device=device,
                                               dtype=torch.int32)
        events.clear()
        with torch.no_grad(), collecting(on_event):
            model.prefill(params, toks, max_len=int(toks.shape[1]),
                          qcfg=qcfg, comp=comp)
        if len(events) != len(schedule):
            raise RuntimeError(
                f"routing collector saw {len(events)} events, expected "
                f"{len(schedule)}")
        values = [v.double().cpu().numpy() for _, _, v in events]
        for (unit, kind, li), (ev_kind, _name, _), value in zip(
                schedule, events, values):
            if ev_kind != kind:
                raise RuntimeError(
                    f"event kind mismatch at {unit}: got {ev_kind}")
            row = 0 if li is None else li
            n_layers = 1 if li is None else n_rep
            if kind == "moe":
                acc = moe_counts.setdefault(
                    unit, np.zeros((n_layers, value.shape[-1]), np.float64))
                acc[row] += value
            else:
                acc = scan_sums.setdefault(unit,
                                           np.zeros((n_layers,), np.float64))
                acc[row] += float(value)
        tokens_total += int(toks.shape[0] * toks.shape[1])
        n_calls += 1

    scan_activity = {k: v / max(n_calls, 1) for k, v in scan_sums.items()}
    return RoutingStats(moe_counts=moe_counts, scan_activity=scan_activity,
                        tokens=tokens_total)


# ------------------------------------------------------- shares + k ladders


def traffic_shares(counts: np.ndarray) -> np.ndarray:
    """Per-layer traffic shares: rows of (L, E) counts normalized to sum 1.
    A row with no kept dispatch falls back to the uniform share."""
    counts = np.asarray(counts, np.float64)
    if counts.ndim == 1:
        counts = counts[None, :]
    totals = counts.sum(axis=-1, keepdims=True)
    uniform = np.full_like(counts, 1.0 / counts.shape[-1])
    with np.errstate(invalid="ignore", divide="ignore"):
        shares = np.where(totals > 0, counts / np.maximum(totals, 1e-12),
                          uniform)
    return shares


def activity_shares(activity: np.ndarray) -> np.ndarray:
    """(L,) activity statistics normalized to shares summing to 1."""
    act = np.asarray(activity, np.float64).reshape(-1)
    total = act.sum()
    if total <= 0:
        return np.full_like(act, 1.0 / max(act.size, 1))
    return act / total


def assign_rank_k(shares: np.ndarray, ladder: Sequence[int]) -> np.ndarray:
    """Bucket units onto a k ladder by traffic rank: hottest -> gentlest.

    ``ladder`` is the set of codebook sizes (order-insensitive); the hottest
    ceil(n / len(ladder)) units get the largest k, the coldest the smallest.
    Monotone: share_i > share_j implies k_i >= k_j. Ties break on unit
    index (a stable sort)."""
    shares = np.asarray(shares, np.float64).reshape(-1)
    gentle_first = sorted({int(k) for k in ladder}, reverse=True)
    if not gentle_first:
        raise ValueError("empty k ladder")
    n, n_l = shares.size, len(gentle_first)
    order = np.argsort(-shares, kind="stable")    # hottest first
    ks = np.zeros(n, np.int64)
    for rank, idx in enumerate(order):
        ks[idx] = gentle_first[min(rank * n_l // max(n, 1), n_l - 1)]
    return ks


def traffic_weighted_energy(unit_energy: np.ndarray,
                            shares: np.ndarray) -> np.ndarray:
    """Scale per-unit tile energies by measured traffic share: ``energy *
    share * n_units``, so uniform traffic changes nothing and the layer
    total stays comparable to the dense accounting."""
    unit_energy = np.asarray(unit_energy, np.float64)
    shares = np.asarray(shares, np.float64)
    return unit_energy * shares * shares.shape[-1]
