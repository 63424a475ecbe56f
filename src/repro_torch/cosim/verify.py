"""Differential verification: the transition-statistics kernel (K1) against
the cosim (port of `repro.cosim.verify`).

`verify_tiles` gates one tile batch; `verify_runner_profile` replays the
port's per-layer tile sampling (`CnnRunner.profile`'s: the same
`layer_seed`, `sample_tiles`, `pad_to_tiles` and `gather_layer_tiles`) on a
runner and gates every layer. Both return plain-dict summaries with the JAX
package's keys, the shape the pipeline's ``--verify-cosim`` pass consumes.

Exactness: the JAX kernel accumulates its (50, 50) group histogram in
float32, exact for integers below 2**24, so the JAX package reports
``exactness_ok`` (fewer than 2**24 transitions in all) beside the result.
K1 counts in int64 and the comparison here takes its integer histogram
before the float32 conversion (`core.profiler.batched_layer_counts`), so it
is exact at any size: ``exactness_ok`` keeps the JAX formula for the
summary's sake, and a false value does not void ``match``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.stats import TILE, pad_to_tiles
from repro_torch.cosim.pe import N_GROUPS
from repro_torch.cosim.systolic import cosim_batched_stats

_F32_EXACT = 2 ** 24

__all__ = ["verify_tiles", "verify_runner_profile"]


def verify_tiles(
    w_tiles: torch.Tensor,
    a_blocks: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    chunk: Optional[int] = None,
) -> dict:
    """Compare K1's transition histogram with the cosim's, exactly.

    w_tiles (n, 64, 64) and a_blocks (n, 64, T) integer tiles on one
    device: K1 on CUDA tensors, its plain version on CPU tensors (the
    device decides, as for every kernel of the port; the JAX package's
    ``use_kernel`` and ``interpret`` knobs have no counterpart). Both must
    reproduce the cosim's integer counts bin for bin."""
    from repro_torch.core.profiler import batched_layer_counts

    w_tiles = torch.as_tensor(w_tiles)
    a_blocks = torch.as_tensor(a_blocks)
    dev = w_tiles.device
    k1_mask = None if mask is None else \
        torch.as_tensor(mask).to(device=dev, dtype=torch.float32)
    _, group_counts, _ = batched_layer_counts(
        w_tiles.to(torch.int32).contiguous(),
        a_blocks.to(torch.int32).contiguous(), mask=k1_mask)
    kernel_hist = group_counts.cpu().numpy().reshape(N_GROUPS, N_GROUPS)
    cosim_hist, toggles = cosim_batched_stats(w_tiles, a_blocks, mask=mask,
                                              chunk=chunk)

    diff = np.abs(kernel_hist - cosim_hist)
    n_tiles = int(w_tiles.shape[0])
    n_masked = n_tiles if mask is None else \
        int((torch.as_tensor(mask) != 0).sum())
    total = n_masked * int(w_tiles.shape[1]) * int(w_tiles.shape[2]) \
        * (int(a_blocks.shape[2]) - 1)
    return {
        "n_tiles": n_masked,
        "n_transitions": total,
        "match": bool(diff.max() == 0) if diff.size else True,
        "max_abs_diff": float(diff.max()),
        "kernel_total": float(kernel_hist.sum()),
        "cosim_total": int(cosim_hist.sum()),
        "toggles": toggles,
        "exactness_ok": bool(total < _F32_EXACT),
    }


def verify_runner_profile(
    runner,
    params,
    state,
    comp,
    *,
    n_batches: int = 1,
    max_tiles: int = 16,
    chunk: Optional[int] = None,
) -> dict:
    """Replay `CnnRunner.profile`'s sampling and cosim-gate every layer.

    Uses the same taps, per-layer seed (`layer_seed`), padding and tile
    gather as the port's profiler, so the gated tiles are exactly the tiles
    the plan's statistics came from (not the tiles `jax.random` picks in
    the JAX package). One K1 launch a layer, on the runner's device."""
    from repro_torch.core.profiler import gather_layer_tiles, sample_tiles
    from repro_torch.core.runner import layer_seed

    taps = runner.capture_taps(params, state, comp, n_batches)
    layers = {}
    for cl in runner.model.comp_layers:
        w_mat, x_col = runner.layer_trace_inputs(cl, taps.pop(cl.name))
        w_pad, x_pad = pad_to_tiles(w_mat.to(torch.int32),
                                    x_col.to(torch.int32))
        total_tiles = ((w_pad.shape[0] // TILE) * (w_pad.shape[1] // TILE)
                       * (x_pad.shape[1] // TILE))
        choice = sample_tiles(total_tiles, max_tiles, layer_seed(cl.name))
        w_tiles, a_blocks = gather_layer_tiles(w_pad, x_pad, choice)
        layers[cl.name] = verify_tiles(w_tiles, a_blocks, chunk=chunk)

    return {
        "layers": layers,
        "n_layers": len(layers),
        "n_tiles": sum(r["n_tiles"] for r in layers.values()),
        "match": all(r["match"] for r in layers.values()),
        "max_abs_diff": max((r["max_abs_diff"] for r in layers.values()),
                            default=0.0),
        "toggles": sum(r["toggles"] for r in layers.values()),
        "exactness_ok": all(r["exactness_ok"] for r in layers.values()),
    }
