"""Dry run of the production meshes: every (arch x shape x mesh) cell laid
out on an abstract H100 mesh (port of `repro.launch.dryrun`).

For each cell, on `repro_torch.launch.mesh.make_production_mesh(abstract=
True)` (no process, no card, no allocation: meta tensors), a JSON manifest
under ``build/dryrun/`` with

  * the bytes each device holds of the step's arguments, from every leaf's
    local shard shape: params, optimizer state, comp, batch and decode
    cache (the counterpart of XLA's ``argument_size_in_bytes``);
  * ``gathered_peak_bytes``: the most bytes a device holds gathered at
    once in the step, which gathers one block at a time where the model
    uses it (`gathered_peak_bytes`: the embedding, plus the largest block's
    full parameters and, where the step trains, its fake-quantized copy and
    its gradient), and ``per_device_peak_bytes``, that plus the arguments'
    bytes (activations not counted);
  * the sharding guard report (which logical axes fell back to
    replication);
  * ``n_devices``; a cell `cell_is_runnable` skips is written as skipped.

The JAX package's manifest also carries XLA's compiled temp bytes,
``cost_analysis``, the collective bytes parsed from the optimized HLO and
`repro.launch.hlo_cost`'s loop-corrected costs; they read a compiled XLA
program, which the port has none of, so they stay the JAX package's
(``hlo_only`` in the manifest).

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k \\
      --multi-pod
  python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import torch

from repro_torch._device import tree_leaves, tree_map

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

HLO_ONLY = ("temp_size_in_bytes", "cost_analysis", "collectives",
            "corrected_cost")
HLO_ONLY_REASON = ("read from XLA's compiled HLO (memory_analysis temp "
                   "bytes, cost_analysis, collectives, launch/hlo_cost.py); "
                   "the port compiles no XLA program")


def device_bytes(tree, shardings) -> int:
    """Bytes one device holds of ``tree`` (meta tensors) on
    ``shardings``: each leaf's local shard shape times its item size."""
    sizes = tree_map(
        lambda t, s: math.prod(s.shard_shape(t.shape)) * t.element_size(),
        tree, shardings)
    return int(sum(tree_leaves(sizes)))


def _nbytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


def gathered_peak_bytes(model, kind: str) -> int:
    """Bytes a device holds gathered at once, at most, in a meshed step of
    ``kind`` (``"train"``, ``"prefill"``, ``"decode"``): the embedding (the
    larger of the token table and the read-out, gathered at use) plus the
    largest block's full parameters (a stacked group's one layer, a tail
    block, an encoder layer) and, in training, its fake-quantized matmul
    weights and its gradient. Train steps hold the parameters in their
    own dtype, serve steps in bfloat16 (`abstract_serve_params`). Every
    parameter is gathered whole on every device, whatever its sharding."""
    from repro_torch.launch import train as TR
    from repro_torch.nn.transformer import block_matmuls

    params = (TR.abstract_train_state(model)["params"] if kind == "train"
              else TR.abstract_serve_params(model))
    embed = max(_nbytes(params["embed"]), _nbytes(params.get("lm_head", {})))
    blocks = []
    for top in ("blocks", "enc_blocks", "tail"):
        groups = params.get(top, {})
        for block in ([groups] if top == "enc_blocks" and groups
                      else groups.values()):
            depth = 1 if top == "tail" else tree_leaves(block)[0].shape[0]
            full = _nbytes(block) // depth
            fq = sum(_nbytes(block[u.split("/")[0]][u.split("/")[1]])
                     for u in block_matmuls(block)) // depth
            blocks.append(full + (fq + full if kind == "train" else 0))
    return embed + max(blocks)


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    from repro_torch.configs import (
        SHAPES,
        cell_is_runnable,
        get_config,
        skip_reason,
    )
    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_production_mesh, mesh_label
    from repro_torch.models.lm import build_lm

    t0 = time.time()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, abstract=True)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_label(mesh),
        "axes": list(mesh.axis_names), "kind": shape.kind, "seq": shape.seq,
        "batch": shape.batch,
    }
    if not cell_is_runnable(arch, shape_name):
        result["status"] = "skipped"
        result["skip_reason"] = skip_reason(arch, shape_name)
        return result

    model = build_lm(cfg)
    guard: list = []
    per_device = {}
    if shape.kind == "train":
        state = TR.abstract_train_state(model)
        state_sh = TR.train_state_shardings(model, mesh, guard_report=guard)
        per_device["params"] = device_bytes(state["params"],
                                            state_sh["params"])
        per_device["opt"] = device_bytes(state["opt"], state_sh["opt"])
        per_device["comp"] = device_bytes(
            TR.comp_abstract(model),
            TR.comp_shardings(model, mesh, guard_report=guard))
        specs = TR.batch_specs(cfg, shape)
        per_device["batch"] = device_bytes(
            specs, TR.batch_shardings(specs, mesh))
    elif shape.kind == "prefill":
        per_device["params"] = device_bytes(
            TR.abstract_serve_params(model),
            TR.make_param_shardings(model.spec, mesh, guard_report=guard))
        specs = TR.batch_specs(cfg, shape)
        per_device["batch"] = device_bytes(
            specs, TR.batch_shardings(specs, mesh))
    else:  # decode
        per_device["params"] = device_bytes(
            TR.abstract_serve_params(model),
            TR.make_param_shardings(model.spec, mesh, guard_report=guard))
        per_device["cache"] = device_bytes(
            TR.decode_cache_specs(model, shape),
            TR.cache_shardings(model, shape, mesh, guard_report=guard))
        tokens = {"tokens": torch.empty((shape.batch, 1), dtype=torch.int32,
                                        device="meta")}
        per_device["batch"] = device_bytes(
            tokens, TR.batch_shardings(tokens, mesh))
    per_device["total"] = sum(per_device.values())
    gathered = gathered_peak_bytes(model, shape.kind)
    result.update({
        "status": "ok",
        "layout_s": round(time.time() - t0, 3),
        "per_device_bytes": per_device,
        "argument_size_in_bytes": per_device["total"],
        "gathered_peak_bytes": gathered,
        "per_device_peak_bytes": per_device["total"] + gathered,
        "guard_report": guard,
        "n_devices": mesh.size,
        "hlo_only": {"fields": list(HLO_ONLY), "why": HLO_ONLY_REASON},
    })
    return result


def cell_path(arch: str, shape: str, multi_pod: bool,
              out_dir: Path = OUT_DIR) -> Path:
    from repro_torch.launch.mesh import production_mesh_layout

    sizes, _ = production_mesh_layout(multi_pod=multi_pod)
    return Path(out_dir) / f"{arch}__{shape}__{'x'.join(map(str, sizes))}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape at both production meshes")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        from repro_torch.configs import ALL_ARCHS, SHAPES

        counts = {"ok": 0, "skipped": 0}
        for arch in ALL_ARCHS:
            for shape in SHAPES:
                for mp in (False, True):
                    result = run_cell(arch, shape, mp)
                    path = cell_path(arch, shape, mp, out_dir)
                    path.write_text(json.dumps(result, indent=2))
                    counts[result["status"]] += 1
                    print(f"{result['status']:7s} {path.name}", flush=True)
        print(json.dumps(counts))
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    result = run_cell(args.arch, args.shape, args.multi_pod)
    path = cell_path(args.arch, args.shape, args.multi_pod, out_dir)
    path.write_text(json.dumps(result, indent=2))
    print(json.dumps({k: v for k, v in result.items()
                      if k != "guard_report"}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
