"""LM-side compression state: per-layer masks + codebooks for stacked blocks
(port of `repro.core.lm_compress`).

Builds a comp tree mirroring the LM's grouped parameter layout:

    comp = {
      "blocks": {"g0": {"attn/wq": CompState, "mlp/w_gate": ...}, ...}
                with leaves stacked over the layer axis,
      "tail":   {"t0": {...}},           # unstacked
      "enc_blocks": {"attn/wq": ...},    # whisper's encoder (stacked)
    }

Eligible tensors are the matmul weights that occupy systolic
weight-stationary registers: attention projections, FFN and expert
matrices and the SSM and RG-LRU mixers' projections. Expert-batched MoE
units carry a leading expert axis (after the layer axis of a stack) and get
one codebook an expert: the walks below slice them per (layer, expert)
into plain 2-D matrices (``blocks/g0/moe/w_gate[3][e2]``), each exported
with its own scale, and the serve artifacts stack back over both axes.
Masks are int8. Key paths, leaf shapes and dtypes are the JAX package's,
so comp trees and exported artifacts cross between the packages in plans.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import export as _export
from repro_torch.core import qat
from repro_torch.kernels.lut_matmul.ops import N_CODES
from repro_torch.kernels.lut_matmul.ref import exact_matmul
from repro_torch.nn.spec import ParamSpec, init_params, ones_init, zeros_init

# sub-module name -> weight keys eligible for weight-value restriction
ELIGIBLE: Dict[str, Tuple[str, ...]] = {
    "attn": ("wq", "wk", "wv", "wo"),
    "xattn": ("wq", "wk", "wv", "wo"),
    "mlp": ("w_gate", "w_up", "w_down"),
    "moe": ("w_gate", "w_up", "w_down",
            "shared_gate", "shared_up", "shared_down"),
    "ssm": ("in_proj", "out_proj"),
    "rglru": ("in_proj", "gate_proj", "w_a", "w_x", "out_proj"),
}
# expert-batched MoE tensors: per-expert codebooks and k (the "mlp" sub
# reuses the key names for plain 2-D matrices)
MOE_EXPERT_KEYS: Tuple[str, ...] = ("w_gate", "w_up", "w_down")


def is_expert_unit(unit: str) -> bool:
    """True for 'moe/w_gate'-style expert-batched units ('sub/key' form)."""
    sub, key = unit.split("/")
    return sub == "moe" and key in MOE_EXPERT_KEYS


def _block_comp_spec(block_spec: dict) -> dict:
    """{'attn/wq': comp-spec-dict} for one (possibly stacked) block spec."""
    out = {}
    for sub, keys in ELIGIBLE.items():
        if sub not in block_spec:
            continue
        for key in keys:
            if key not in block_spec[sub]:
                continue
            p: ParamSpec = block_spec[sub][key]
            stacked = bool(p.axes and p.axes[0] == "layers")
            if is_expert_unit(f"{sub}/{key}"):
                # leading (layers?, expert) axes: one codebook an expert
                lead = p.shape[:2] if stacked else p.shape[:1]
                lead_axes = ("layers", "expert") if stacked else ("expert",)
            else:
                lead = (p.shape[0],) if stacked else ()
                lead_axes = ("layers",) if stacked else ()
            out[f"{sub}/{key}"] = {
                "mask": ParamSpec(p.shape, torch.int8, p.axes, ones_init),
                "codebook": ParamSpec((*lead, qat.K_MAX), torch.int32,
                                      (*lead_axes, None), zeros_init),
                "codebook_k": ParamSpec(lead, torch.int32, lead_axes,
                                        zeros_init),
            }
    return out


def make_lm_comp_spec(model) -> dict:
    """Comp spec tree (ParamSpec leaves) for the whole LM."""
    comp: dict = {}
    spec = model.spec
    for top in ("blocks", "tail"):
        if top in spec:
            comp[top] = {g: _block_comp_spec(spec[top][g])
                         for g in spec[top]}
    if "enc_blocks" in spec:
        comp["enc_blocks"] = _block_comp_spec(spec["enc_blocks"])
    return comp


def _unit_nodes(tree: dict):
    """(top, group or None, node) of every block node of a comp-shaped
    tree: ``blocks``/``tail`` hold groups of units, ``enc_blocks`` holds
    its units directly."""
    for top, node in tree.items():
        if top == "enc_blocks":
            yield top, None, node
        else:
            for g, entries in node.items():
                yield top, g, entries


def init_lm_comp(model, *, device) -> dict:
    """Concrete identity comp (all-ones masks, empty codebooks)."""
    return init_params(0, make_lm_comp_spec(model), device)


def lm_comp_layers(model) -> List[str]:
    """Flat names of compressible units ('blocks/g0/attn/wq', ...,
    'enc_blocks/attn/wq')."""
    return [f"{top}/{k}" if g is None else f"{top}/{g}/{k}"
            for top, g, entries in _unit_nodes(make_lm_comp_spec(model))
            for k in entries]


# ---------------------------------------------------------------- serving

# how each eligible weight reshapes to a (K, N) serving matrix:
# "in_first": contraction over axis 0, outputs flattened (wq/wk/wv (d,H,hd))
# "out_last": contraction over all leading axes (2-D mats, wo (H,hd,d))
_SERVE_LAYOUTS: Dict[str, str] = {
    "wq": "in_first", "wk": "in_first", "wv": "in_first", "wo": "out_last",
}


def _serve_layout(key: str, ndim: int) -> Optional[str]:
    """Layout for the 4-bit LUT GEMM; None = not servable as one matmul."""
    if ndim == 2:
        return "out_last"
    if ndim == 3:
        return _SERVE_LAYOUTS.get(key)
    return None


def _slice_comp(c: Optional[dict], idx: tuple) -> Optional[dict]:
    """Per-slice comp entry for one (layer[, expert]) slice of a unit."""
    if c is None:
        return None
    out = {"mask": c["mask"][idx], "codebook": c["codebook"][idx],
           "codebook_k": c["codebook_k"][idx]}
    if "msr_bits" in c:
        mb = c["msr_bits"]
        # msr_bits is a Python int, a 0-d tensor or per-layer; never
        # per-expert
        out["msr_bits"] = mb if not isinstance(mb, torch.Tensor) \
            or mb.ndim == 0 else mb[idx[0]]
    return out


def iter_eligible_units(model, params: dict, comp: Optional[dict] = None, *,
                        include_skipped: bool = False):
    """Yield (name, weight, comp_entry_or_None, layout) for every eligible
    matmul the serving path treats as one (K, N) GEMM.

    Stacked units are yielded per layer (``blocks/g0/attn/wq[3]`` for layer
    3), each slice with its own comp slice: the per-slice semantics of
    the fake-quant forward. Expert units are yielded per (layer, expert)
    (``blocks/g0/moe/w_gate[3][e2]``; ``tail/t0/moe/w_up[e1]`` unstacked),
    the per-expert fake-quant's slices. With ``comp=None`` the comp entries
    are None.
    With ``include_skipped``, units without a serving layout are yielded
    once (unsliced) with ``layout=None``."""
    for top, g, units in _unit_nodes(make_lm_comp_spec(model)):
        node_p = params[top] if g is None else params[top][g]
        node_c = None if comp is None else (comp[top] if g is None
                                            else comp[top][g])
        for unit in units:
            sub, key = unit.split("/")
            w = node_p[sub][key]
            stacked = units[unit]["mask"].axes[:1] == ("layers",)
            c = None if node_c is None else node_c[unit]
            base = f"{top}/{unit}" if g is None else f"{top}/{g}/{unit}"
            if is_expert_unit(unit):
                layers = range(w.shape[0]) if stacked else (None,)
                for li in layers:
                    lw = w if li is None else w[li]
                    for ei in range(lw.shape[0]):
                        idx = (ei,) if li is None else (li, ei)
                        name = (f"{base}[e{ei}]" if li is None
                                else f"{base}[{li}][e{ei}]")
                        yield name, lw[ei], _slice_comp(c, idx), "out_last"
            elif stacked:
                layout = _serve_layout(key, w.ndim - 1)
                if layout is None:
                    if include_skipped:
                        yield base, w, c, None
                    continue
                for li in range(w.shape[0]):
                    yield (f"{base}[{li}]", w[li], _slice_comp(c, (li,)),
                           layout)
            else:
                layout = _serve_layout(key, w.ndim)
                if layout is not None or include_skipped:
                    yield base, w, c, layout


def iter_restricted_units(model, params: dict, comp: dict):
    """Yield (name, weight, comp_entry, layout) for every *servable* unit:
    the `iter_eligible_units` walk filtered to active <= 16-value
    codebooks."""
    for name, w, c, layout in iter_eligible_units(model, params, comp):
        if c is not None and _export.servable(c):
            yield name, w, c, layout


def export_lm_matmuls(model, params: dict, comp: dict, *,
                      block_k: int = 128
                      ) -> Tuple[Dict, List[Dict[str, str]]]:
    """Export every restricted eligible LM matmul to a `ServeArtifact`.

    Returns ``({unit_name: ServeArtifact}, skip_report)``; the skip report
    lists every eligible unit that did not export, as ``{"unit", "reason",
    "detail"}`` with reason ``no_layout``, ``inactive_codebook`` or
    ``codebook_too_large``."""
    out: Dict = {}
    skips: List[Dict[str, str]] = []
    for name, w, c, layout in iter_eligible_units(model, params, comp,
                                                  include_skipped=True):
        if layout is None:
            skips.append({"unit": name, "reason": "no_layout",
                          "detail": f"rank-{w.ndim} tensor has no serving "
                                    "layout"})
            continue
        k = 0 if c is None else int(c["codebook_k"])
        if not (c is not None and _export.servable(c)):
            reason = "inactive_codebook" if k <= 0 else "codebook_too_large"
            skips.append({"unit": name, "reason": reason,
                          "detail": f"codebook_k={k}"})
            continue
        out[name] = _export.export_layer(w, c, kind="dense", layout=layout,
                                         block_k=block_k)
    return out, skips


def _stack_arts(slices):
    """Per-slice artifacts -> one artifact whose fields carry a leading
    (layer or expert) axis (None if any slice is not servable)."""
    if any(s is None for s in slices):
        return None
    return dataclasses.replace(
        slices[0], packed=torch.stack([s.packed for s in slices]),
        codebook=torch.stack([s.codebook for s in slices]),
        scale=torch.stack([s.scale for s in slices]))


def attach_serve_artifacts(model, params: dict, comp: dict, *,
                           block_k: int = 128) -> Tuple[dict, int]:
    """Return (comp copy with packed `ServeArtifact`s attached, unit count).

    Every servable eligible unit gains a ``"serve"`` key in its comp entry
    holding the packed 4-bit form of its weight; `QuantConfig.serve`
    forwards (attention `_project`, the FFN's matmuls, `quantized_mm`)
    dispatch on that key to the LUT GEMM. Stacked units export per layer,
    each with its own scale and codebook (the per-slice fake-quant
    semantics), stacked along the layer axis. Expert units export per
    (layer, expert) and stack over the expert axis, then the layer axis
    (`export_expert`; `repro_torch.nn.moe` slices them back per expert).
    Units that are not servable keep their entries unchanged and run on
    fake-quant."""

    def all_servable(c) -> bool:
        ks = c["codebook_k"].reshape(-1)
        return bool(((ks > 0) & (ks <= N_CODES)).all())

    def attach_entries(node_p, entries):
        new, n = {}, 0
        for unit, c in entries.items():
            sub, key = unit.split("/")
            w = node_p[sub][key]
            entry = {k: v for k, v in c.items() if k != "serve"}
            if is_expert_unit(unit):
                art = export_expert(w, c, block_k=block_k) \
                    if all_servable(c) else None
            elif c["codebook"].ndim == 2:        # stacked over layers
                layout = _serve_layout(key, w.ndim - 1)
                art = None if layout is None or not all_servable(c) else \
                    _stack_arts([_export.export_layer(
                        w[li], _slice_comp(c, (li,)), kind="dense",
                        layout=layout, block_k=block_k)
                        for li in range(w.shape[0])])
            else:
                layout = _serve_layout(key, w.ndim)
                art = None if layout is None or not _export.servable(c) else \
                    _export.export_layer(w, c, kind="dense", layout=layout,
                                         block_k=block_k)
            if art is not None:
                entry["serve"] = art
                n += 1
            new[unit] = entry
        return new, n

    out, total = {}, 0
    for top, groups in comp.items():
        if top == "enc_blocks":
            out[top], total_enc = attach_entries(params[top], groups)
            total += total_enc
        elif top in ("blocks", "tail"):
            out[top] = {}
            for g, entries in groups.items():
                out[top][g], n = attach_entries(params[top][g], entries)
                total += n
        else:
            out[top] = groups
    return out, total


def export_expert(w: torch.Tensor, c: dict, *, block_k: int = 128):
    """The serve artifact of an expert unit, (L, E, ...) stacked or (E,
    ...) unstacked (its codebook (L, E, 32) or (E, 32)): one export a
    (layer, expert) slice with that slice's comp, stacked over the expert
    axis and then the layer axis."""
    def experts(lw, lc_idx):
        return _stack_arts([_export.export_layer(
            lw[ei], _slice_comp(c, (*lc_idx, ei)), kind="dense",
            layout="out_last", block_k=block_k)
            for ei in range(lw.shape[0])])

    if c["codebook"].ndim == 3:
        return _stack_arts([experts(w[li], (li,))
                            for li in range(w.shape[0])])
    return experts(w, ())


def lut_parity_report(model, params: dict, comp: dict, arts: Dict, *,
                      check_units: int = 4, seed: int = 2,
                      x: Optional[Dict[int, torch.Tensor]] = None
                      ) -> Dict[str, float]:
    """LUT-GEMM vs fake-quant-matmul parity on random activations.

    Checks up to ``check_units`` exported units (units without an artifact
    are skipped). Returns {unit_name: rel_err}. The activations are (4,
    K) a unit: ``x[K]`` where given (tests pass the JAX package's
    ``jax.random`` draws), else drawn from a CPU `torch.Generator` seeded
    with ``seed``. The fake-quant product is correctly rounded
    (`exact_matmul`), as the served one is."""
    checked: Dict[str, float] = {}
    for name, w, c, layout in iter_restricted_units(model, params, comp):
        if len(checked) >= check_units:
            break
        if name not in arts:
            continue
        art = arts[name]
        if x is not None:
            xk = x[art.k_dim]
        else:
            xk = torch.randn((4, art.k_dim),
                             generator=torch.Generator().manual_seed(seed))
        xk = xk.to(device=w.device, dtype=torch.float32)
        w_fake = qat.fake_quant_weights([w], [c])[0]
        w_mat = (w_fake.reshape(w.shape[0], -1) if layout == "in_first"
                 else w_fake.reshape(-1, w.shape[-1]))
        want = exact_matmul(xk, w_mat)
        got = _export.serve_dense(xk, art)
        checked[name] = float(
            torch.linalg.norm(got - want)
            / torch.clamp(torch.linalg.norm(want), min=1e-9))
    return checked


def symmetric_codebook_values(k: int) -> list:
    """Restricted set of exactly k int8 values: 0 plus levels spread over the
    int8 range (one extra negative level when k is even)."""
    n_neg = k // 2
    n_pos = k - 1 - n_neg
    values = sorted(
        {0}
        | {-int(v) for v in np.linspace(16, 120, n_neg)}
        | {int(v) for v in np.linspace(16, 120, n_pos)})
    assert len(values) == k, (k, values)
    return values


def restrict_all_codebooks(model, comp: dict, values) -> dict:
    """Apply one codebook value set to every compressible unit of the LM."""
    for path in lm_comp_layers(model):
        comp = set_codebook(comp, path, values)
    return comp


def set_codebook(comp: dict, path: str, values, layer: Optional[int] = None,
                 expert: Optional[int] = None) -> dict:
    """Functional codebook update for unit ``path``
    ('blocks/g0/mlp/w_down'). For stacked units ``layer`` selects the
    layer; for expert units ``expert`` selects the expert. A None index
    sets the codebook over that whole axis."""
    parts = path.split("/")
    unit = "/".join(parts[-2:])
    node_path = parts[:-2]

    def set_entry(entry):
        cb, k = qat.make_codebook(values, device=entry["codebook"].device)
        lead = entry["codebook"].ndim - 1      # () | (L,) | (E,) | (L, E)
        if lead == 0:
            entry["codebook"], entry["codebook_k"] = cb, k
            return entry
        if lead == 2:
            idx = (layer, expert)
        else:
            idx = (expert,) if is_expert_unit(unit) else (layer,)
        # a None index covers its whole axis
        sel = tuple(slice(None) if i is None else i for i in idx)
        entry["codebook"] = entry["codebook"].clone()
        entry["codebook_k"] = entry["codebook_k"].clone()
        entry["codebook"][sel] = cb
        entry["codebook_k"][sel] = k
        return entry

    def update(tree, keys):
        out = dict(tree)
        if not keys:
            out[unit] = set_entry(dict(tree[unit]))
            return out
        out[keys[0]] = update(tree[keys[0]], keys[1:])
        return out

    return update(comp, node_path)
