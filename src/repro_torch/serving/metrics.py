"""Per-request accounting for the serving engine (port of
`repro.serving.metrics`).

Latency, time-to-first-token, throughput, and an estimated MAC energy per
request. The energy estimate extends the paper's tile-level layer model
(`repro_torch.core.layer_energy`) to serving traffic: every eligible LM
matmul contributes

    E_unit(1 token) = sum_w counts_padded(w) * LUT(w) * 2T * ceil(1/64 tiles)

with ``counts_padded`` the int8-projected weight histogram (codebook
restriction applied when the engine serves compressed) and LUT the
traffic-agnostic `repro_torch.core.energy_lut.uniform_trace_lut` (no
profiled activation statistics exist at serve time). A request is charged
``per_token_energy * (prompt_len + new_tokens)`` — the token positions it
actually pushed through the array.

The per-request charge deliberately excludes padded/idle work. The engine
tracks the positions it *actually executed* (padding rows, idle lockstep
slots, chunk padding) separately; `summarize` exposes the gap as
``energy_eu_overhead`` plus a ``slot_utilization`` ratio (charged /
executed positions).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.core import lm_compress, qat
from repro_torch.core.energy_lut import uniform_trace_lut
from repro_torch.core.layer_energy import (
    dense_matmul_dims,
    layer_energy_from_counts,
    weight_value_counts,
)


@dataclasses.dataclass
class RequestStats:
    """Timing/energy record for one served request (times are wall-clock
    seconds from a shared origin)."""

    rid: int
    prompt_len: int
    new_tokens: int
    bucket: tuple            # BucketSpec.key()
    # lifecycle timestamps stay None until the event happens — 0.0 is a
    # valid perf_counter reading, not a usable "unset" sentinel
    t_submit: Optional[float] = None
    t_admitted: Optional[float] = None   # prefill of this request started
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    energy_eu: float = 0.0
    tenant: str = "default"
    plan_id: str = ""

    @property
    def latency_s(self) -> float:
        if self.t_finish is None or self.t_submit is None:
            raise ValueError(f"request {self.rid} has not finished; "
                             f"latency_s is undefined")
        return self.t_finish - self.t_submit

    @property
    def ttft_s(self) -> float:
        if self.t_first_token is None or self.t_submit is None:
            raise ValueError(f"request {self.rid} has no first token yet; "
                             f"ttft_s is undefined")
        return self.t_first_token - self.t_submit


def percentile(values: List[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]); 0.0 on empty input."""
    if not values:
        return 0.0
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


def summarize(stats: List[RequestStats], wall_s: float,
              cache_stats: Optional[dict] = None, *,
              executed_positions: Optional[int] = None,
              per_token_energy_eu: Optional[float] = None) -> Dict:
    """Aggregate report over a set of completed requests.

    ``executed_positions`` (with ``per_token_energy_eu``) adds the
    padded-work accounting: ``slot_utilization`` = charged / executed
    positions and ``energy_eu_overhead`` = energy of the executed positions
    no request was charged for.
    """
    lat = [s.latency_s for s in stats]
    ttft = [s.ttft_s for s in stats]
    new_tokens = sum(s.new_tokens for s in stats)
    all_tokens = sum(s.prompt_len + s.new_tokens for s in stats)
    out = {
        "requests": len(stats),
        "wall_s": wall_s,
        "new_tokens": new_tokens,
        "total_tokens": all_tokens,
        "tokens_per_s": new_tokens / wall_s if wall_s > 0 else 0.0,
        "latency_p50_s": percentile(lat, 50),
        "latency_p90_s": percentile(lat, 90),
        "latency_p99_s": percentile(lat, 99),
        "ttft_p50_s": percentile(ttft, 50),
        "ttft_p90_s": percentile(ttft, 90),
        "ttft_p99_s": percentile(ttft, 99),
        "energy_eu_total": sum(s.energy_eu for s in stats),
        "energy_eu_per_token": (sum(s.energy_eu for s in stats)
                                / max(all_tokens, 1)),
    }
    if executed_positions is not None:
        executed = int(executed_positions)
        out["executed_positions"] = executed
        out["slot_utilization"] = (all_tokens / executed) if executed else 0.0
        if per_token_energy_eu is not None:
            idle = max(executed - all_tokens, 0)
            out["energy_eu_overhead"] = float(per_token_energy_eu) * idle
    if cache_stats:
        out.update({f"cache_{k}": v for k, v in cache_stats.items()})
    return out


# ------------------------------------------------------------------ energy


def unit_energies(model, params, comp=None,
                  lut: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """{unit: one-token MAC energy (eu), a 0-d float32 tensor} of every
    eligible LM matmul (`lm_compress.iter_eligible_units`, stacked units
    per layer), on the paper's 64x64 weight-stationary array, priced with
    ``lut`` (default: the uniform-trace LUT). The LM target's energy model
    and `per_token_energy` both read this."""
    out: Dict[str, torch.Tensor] = {}
    for name, w, c, layout in lm_compress.iter_eligible_units(model, params,
                                                              comp):
        if lut is None:
            lut = uniform_trace_lut(device=w.device)
        w_int = qat.quantize_weight_int(w, c)
        mat = (w_int.reshape(w_int.shape[0], -1) if layout == "in_first"
               else w_int.reshape(-1, w_int.shape[-1]))
        dims = dense_matmul_dims(fan_in=mat.shape[0], fan_out=mat.shape[1],
                                 n_tokens=1)
        counts = weight_value_counts(mat.T, dims)  # (M, K) layout for padding
        out[name] = layer_energy_from_counts(counts, lut, dims)
    return out


def per_token_energy(model, params, comp=None) -> float:
    """Estimated MAC energy (eu) of pushing one token position through every
    eligible LM matmul: the `unit_energies` summed in float32 in walk order,
    as the JAX package sums them."""
    total = torch.zeros((), dtype=torch.float32)
    for e in unit_energies(model, params, comp).values():
        total = total + e.cpu()
    return float(total)
