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
    parameters and, where the step trains, its fake-quantized copy and its
    gradient; a tensor-parallel unit's leaves count this device's chunk
    over "model", every other leaf whole), and ``per_device_peak_bytes``,
    that plus the arguments' bytes (activations not counted);
  * ``flops``: the step's products on this layout (`step_costs`: ``total``,
    ``by_unit`` (projections, attention scores and values, ffn, moe (the
    experts), router, recurrent mixer, read-out), with remat's recompute,
    the backward and ``grad_accum`` counted; ``remat_tail``, the recompute
    the JAX package's XLA step does not run, and ``xla_only``, the SSD
    products it runs and the port does not: with both, the JAX package's
    loop-corrected count);
  * ``collectives``: the bytes (of each collective's result, as the JAX
    package parses XLA's) and the count of the step's all-gathers,
    reduce-scatters and all-reduces on a device, and ``total_bytes``;
  * the sharding guard report (which logical axes fell back to
    replication);
  * ``n_devices``; a cell `cell_is_runnable` skips is written as skipped.

The JAX package's manifest also carries XLA's compiled temp bytes (the
activations); that one reads a compiled XLA program, which the port has
none of (``hlo_only`` in the manifest).

The flags are the JAX CLI's step knobs: ``--rules`` (logical=mesh axes,
``+`` joining several, ``None`` replicating: ``--rules
heads=None,mlp=None,vocab=None,kv_heads=None`` is the storage-only step,
no tensor-parallel unit), ``--no-qat``, ``--no-comp``, ``--no-remat``,
``--q-block``, ``--kv-block``, ``--flash``, ``--grad-accum``, ``--kv-seq``
(the decode cache's sequence over "model"), ``--moe-local`` (the MoE's
local dispatch, recorded in the manifest as ``moe_local_dispatch``: the
port's meshed step scatters locally and runs each rank's experts either
way, so no count changes) and ``--tag`` (a suffix of the manifest's
name). ``--remat-save-qat`` is refused: it changes only the activations'
bytes, which the dry run does not count yet. There is no compile step, so
there is no ``--jobs``: every cell is laid out in this process.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k \\
      --multi-pod
  python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k \\
      --rules heads=None,mlp=None,vocab=None,kv_heads=None --tag storage
  python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch._device import tree_leaves, tree_map

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

HLO_ONLY = ("temp_size_in_bytes",)
HLO_ONLY_REASON = ("XLA's memory_analysis temp bytes (the activations) read "
                   "a compiled XLA program; the port compiles none")


def device_bytes(tree, shardings) -> int:
    """Bytes one device holds of ``tree`` (meta tensors) on
    ``shardings``: each leaf's local shard shape times its item size."""
    sizes = tree_map(
        lambda t, s: math.prod(s.shard_shape(t.shape)) * t.element_size(),
        tree, shardings)
    return int(sum(tree_leaves(sizes)))


def _nbytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


def _layer_shape(t: torch.Tensor, stacked: bool) -> Tuple[int, ...]:
    return tuple(t.shape[1:] if stacked else t.shape)


def _layer_sharding(s, ndim: int, stacked: bool):
    from repro_torch.distributed.sharding import NamedSharding, PartitionSpec

    if not stacked:
        return s
    return NamedSharding(s.mesh, PartitionSpec(*s.entries(ndim)[1:]))


def _at_use(s, sub_axes):
    """(the layout a leaf on ``s`` is gathered on, the sharding whose
    slice the gathered tensor is): a tensor-parallel sub-module's leaf
    keeps its chunk along ``sub_axes`` (`LayerGather`)."""
    from repro_torch.distributed.sharding import (
        NamedSharding,
        PartitionSpec,
        _axes_of,
        without_axes,
    )

    if not sub_axes:
        return s, NamedSharding(s.mesh, PartitionSpec())
    kept = [tuple(a for a in _axes_of(e) if a in sub_axes) or None
            for e in s.spec]
    return without_axes(s, sub_axes), NamedSharding(s.mesh,
                                                     PartitionSpec(*kept))


def _walk_leaves(tree, sh, rel=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _walk_leaves(tree[k], sh[k], rel + (k,))
    else:
        yield rel, tree, sh


def gathered_peak_bytes(model, kind: str, mesh=None, rules=None) -> int:
    """Bytes a device holds gathered at once, at most, in a meshed step of
    ``kind`` (``"train"``, ``"prefill"``, ``"decode"``) on ``mesh`` and
    ``rules``: the embedding (the larger of the token table and the
    read-out, gathered at use) plus the largest block's parameters (a
    stacked group's one layer, a tail block, an encoder layer) and, in
    training, its fake-quantized matmul weights and its gradient. Train
    steps hold the parameters in their own dtype, serve steps in bfloat16
    (`abstract_serve_params`). A tensor-parallel sub-module's leaf counts
    its chunk over the model axes (`kept_axes`: the MoE's experts their
    chunk of the experts or of the hidden width), every other leaf whole;
    without ``mesh`` every leaf counts whole (the storage-only step)."""
    from repro_torch.distributed.sharding import (
        DEFAULT_RULES,
        kept_axes,
        make_param_shardings,
    )
    from repro_torch.launch import train as TR
    from repro_torch.nn.transformer import block_matmuls

    params = (TR.abstract_train_state(model)["params"] if kind == "train"
              else TR.abstract_serve_params(model))
    rules = DEFAULT_RULES if rules is None else rules
    p_sh = None if mesh is None else make_param_shardings(model.spec, mesh,
                                                          rules)

    def used(path, tree, stacked):
        """Gathered bytes of ``tree`` (at ``path``) by unit name."""
        sh = p_sh
        for k in path:
            sh = None if sh is None else sh[k]
        out = {}
        for rel, leaf, s in _walk_leaves(tree, tree if sh is None else sh):
            shape = _layer_shape(leaf, stacked)
            axes = () if sh is None else kept_axes(p_sh, (*path, *rel),
                                                   rules)
            if axes:
                _, kept = _at_use(_layer_sharding(s, leaf.ndim, stacked),
                                  axes)
                shape = kept.shard_shape(shape)
            out["/".join(rel)] = math.prod(shape) * leaf.element_size()
        return out

    embed = max(sum(used(("embed",), params["embed"], False).values()),
                sum(used(("lm_head",), params.get("lm_head", {}),
                         False).values()) if "lm_head" in params else 0)
    blocks = []
    for top in ("blocks", "enc_blocks", "tail"):
        groups = params.get(top, {})
        items = ([((top,), groups)] if top == "enc_blocks" and groups
                 else [((top, g), b) for g, b in groups.items()])
        for path, block in items:
            sizes = used(path, block, top != "tail")
            full = sum(sizes.values())
            fq = sum(sizes[u] for u in block_matmuls(block))
            blocks.append(full + (fq + full if kind == "train" else 0))
    return embed + max(blocks)


# ================================================================ step costs


class _Tally:
    """Per-device FLOPs by unit and collectives by kind of one step."""

    def __init__(self):
        from repro_torch.distributed.sharding import COLLECTIVE_KINDS

        self.flops: Dict[str, int] = {}
        self.remat_tail = 0
        self.xla_only = 0
        self.coll = {k: {"bytes": 0, "count": 0} for k in COLLECTIVE_KINDS}

    def mm(self, unit: str, m: int, k: int, n: int, times: int = 1):
        """``times`` products of (m, k) @ (k, n)."""
        self.add(unit, 2 * m * k * n * times)

    def add(self, unit: str, flops: int):
        self.flops[unit] = self.flops.get(unit, 0) + int(flops)

    def coll_add(self, kind: str, nbytes: int, times: int = 1):
        if times:
            self.coll[kind]["bytes"] += int(nbytes) * times
            self.coll[kind]["count"] += times

    def result(self) -> dict:
        coll = {k: dict(v) for k, v in self.coll.items()}
        coll["total_bytes"] = sum(v["bytes"] for v in coll.values())
        return {"flops": {"total": sum(self.flops.values()),
                          "by_unit": dict(sorted(self.flops.items())),
                          "remat_tail": self.remat_tail,
                          "xla_only": self.xla_only},
                "collectives": coll}


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _pad(n: int, block: int) -> int:
    return -(-n // block) * block


def _ssd_chunks(cfg, seq: int) -> Tuple[int, int]:
    """(chunks, chunk length) of the SSD over ``seq`` positions (padded to
    a multiple of the chunk)."""
    l = cfg.ssm_dims().chunk
    return _pad(seq, l) // l, l


def _mixer_flops(cfg, bt: str, rows: int, seq: int, train: bool,
                 decode: bool, m: int = 1) -> Tuple[int, int]:
    """(forward, backward) products of one recurrent mixer (``ssm``,
    ``rglru``) over ``rows`` x ``seq`` positions (one in decode) on a rank
    that runs ``1 / m`` of its features (`repro_torch.nn.ssm`,
    `repro_torch.nn.rglru`): the projections (the SSM's in_proj on its
    stored chunk of columns, the RG-LRU's w_a and w_x on the rank's rows),
    and the SSD's batched products on the rank's heads, its C B^T scores
    once a group on every rank; the scan has none. The backward takes both
    operands' gradients of every product whose output a gradient reads (at
    one chunk the SSD's input states feed only the final state, and its
    state term reads no state)."""
    tokens = rows * (1 if decode else seq)
    d = cfg.d_model
    if bt == "rglru":
        r = cfg.rglru_dims().d_rnn
        fwd = 2 * tokens * (2 * d * r // m + 2 * (r // m) * r + r // m * d)
        return fwd, 2 * fwd if train else 0
    sd = cfg.ssm_dims()
    io = 2 * sd.d_inner + 2 * sd.n_groups * sd.d_state + sd.n_heads
    hl, p, n, g = sd.n_heads // m, sd.head_dim, sd.d_state, sd.n_groups
    proj = 2 * tokens * d * io // m + 2 * tokens * sd.d_inner // m * d
    if decode:
        return proj + 2 * rows * hl * p * n, 0
    nc, l = _ssd_chunks(cfg, seq)
    one = 2 * rows * nc * l       # a product's factor over rows and chunks
    scores, diag = one * g * l * n, one * hl * l * p
    states = off = one * hl * p * n
    fwd = proj + scores + diag + states + off
    if not train:
        return fwd, 0
    return fwd, 2 * (proj + scores + diag) + off + (
        2 * states + off if nc > 1 else 0)


def _xla_ssd_extra(cfg, rows: int, seq: int, m: int, runs: int,
                   train: bool) -> int:
    """The products of one SSM layer that the JAX package's compiled step
    runs and the port's does not: its C B^T scores one a head (B and C
    repeated a head) where the port's are one a group, and in the backward
    two decay gradients XLA writes as products (the input states' over P,
    the state term's over N); counted at two or more chunks, where they
    were read off XLA's HLO."""
    sd = cfg.ssm_dims()
    nc, l = _ssd_chunks(cfg, seq)
    hl = sd.n_heads // m
    extra = 2 * rows * nc * l * l * sd.d_state * (hl - sd.n_groups) \
        * (runs + (2 if train else 0))
    if train:
        extra += 2 * rows * nc * l * hl * (sd.head_dim + sd.d_state)
    return extra


def step_costs(model, mesh, rules=None, kind: str = "train",
               batch: int = 1, seq: int = 1, step_cfg=None, *,
               kv_seq_shard: bool = False, param_dtype=None,
               enc_seq: Optional[int] = None) -> dict:
    """Per-device FLOPs (``2 M K N`` a product, by unit) and collectives
    (result bytes and count by kind) of one meshed step of ``kind`` on
    ``mesh``: what `repro_torch.launch.train`'s steps run on each rank,
    from the spec's shapes as the model code computes them
    (`tests/test_torch_mesh2d.py` holds both to what the spawned ranks
    count). ``batch`` x ``seq``: the cell's (a decode cell's cache length).
    ``param_dtype``: the parameters' dtype where the caller's differ from
    the cell's (train: the spec's; prefill and decode: bfloat16).
    ``enc_seq``: the encoder-decoder family's frames where they are not
    the cell's ``seq`` (its decoder then takes ``seq`` tokens).

    Train: the QAT forward (or not: ``step_cfg.qat``), remat's recompute of
    every layer (its forward products and collectives twice: a meshed
    step's recompute runs the whole layer), the backward (both operands'
    gradients of every product but an encoder input's, the flash
    backward's five tile products a block against autograd's four),
    ``grad_accum`` micro-batches. Collectives: each gather at use and its
    gradient's reduction (`reduce_plan`); tensor-parallel all-reduces (a
    row-parallel output, the gradient of the input a sub-module's column
    products share, once: float64 under QAT, the activations' dtype
    otherwise; a replicated K/V weight's gradient); the MoE's split
    experts' all-gathered outputs and the gradient of the x their scatter
    reads (summed once with the shared experts' input gradient where both
    split over the same axes), tensor-parallel experts' row-parallel
    outputs and their buffer's gradient; the split
    vocabulary's lookup sum, read-out gradient and the loss's three
    reductions; K3's per-column MAX; each activation
    fake-quant's amax MAX; the loss's two sums, the MoE auxiliary sums and
    the clip norm. Prefill and decode: the forward without QAT or
    reductions over the batch; decode also gathers the held cache's dims
    the step does not split (`compute_cache_shardings`), both ways.
    ``flops["remat_tail"]``: the recompute the JAX package's XLA step does
    not run and the port's does: the last product of each checkpointed
    body (one a pattern repeat, one an encoder layer), whose output no
    gradient reads, and the whole forward of the unstacked tail blocks,
    which the JAX package runs unchecked. ``flops["xla_only"]``: the
    products XLA runs and the port does not (`_xla_ssd_extra`). The split
    recurrent mixers are counted as `repro_torch.nn.ssm` and
    `repro_torch.nn.rglru` run them (`_mixer_flops`, `mixer`), an encoder
    layer over its frames (``enc_seq`` where they are not ``seq``)."""
    from repro_torch.core.lm_compress import is_expert_unit
    from repro_torch.distributed.sharding import (
        DEFAULT_RULES,
        _axes_of,
        _mesh_size,
        batch_sharding,
        kept_axes,
        make_param_shardings,
        reduce_plan,
        tp_axes,
    )
    from repro_torch.launch import train as TR
    from repro_torch.nn.moe import capacity
    from repro_torch.nn.spec import flatten_with_names
    from repro_torch.nn.transformer import RECURRENT, block_matmuls

    rules = DEFAULT_RULES if rules is None else rules
    cfg = model.cfg
    step_cfg = TR.StepConfig() if step_cfg is None else step_cfg
    train, decode = kind == "train", kind == "decode"
    qat = train and step_cfg.qat
    remat = train and step_cfg.remat
    runs = 2 if remat else 1
    n_micro = step_cfg.grad_accum if train else 1
    back = 2 if train else 0
    t = _Tally()
    p_sh = make_param_shardings(model.spec, mesh, rules)
    params = (TR.abstract_train_state(model)["params"] if train
              else TR.abstract_serve_params(model))
    if param_dtype is not None:
        params = tree_map(lambda x: x.to(param_dtype), params)
    cdt = _itemsize(cfg.cdtype)
    row_dt = 8 if qat else cdt        # a tensor-parallel sum's dtype
    b_mu = batch // n_micro
    batch_axes = _axes_of(batch_sharding(mesh, (b_mu,), rules).spec[0])
    batch_group = _mesh_size(mesh, batch_axes) > 1
    rows = b_mu // _mesh_size(mesh, batch_axes)
    specs = TR.batch_specs(cfg, type("Cell", (), dict(
        batch=batch, seq=seq, kind="train"))())
    s_tok = 1 if decode else specs["tokens"].shape[1]
    s_all = s_tok + (cfg.prefix_len if "prefix_embeds" in specs
                     and not decode else 0)
    s_enc = specs["enc_embeds"].shape[1] if "enc_embeds" in specs else 0
    if enc_seq is not None and s_enc:
        s_enc, s_tok = enc_seq, 1 if decode else seq
        s_all = s_tok
    tokens = rows * s_all
    qb, kb = step_cfg.q_block, step_cfg.kv_block
    cell = type("Cell", (), dict(batch=batch, seq=seq, kind=kind))()
    cache = TR.decode_cache_specs(model, cell) if decode else None

    def split(*path) -> Tuple[Tuple[str, ...], int]:
        axes = tp_axes(p_sh, path, rules)
        return axes, _mesh_size(mesh, axes)

    def amax(tp_size: int = 1, times: int = 1):
        """Activation fake-quant calls' amax MAX (training under QAT)."""
        if qat and (batch_group or tp_size > 1):
            t.coll_add("all-reduce", cdt, times)

    def gather_at_use(path, tree, sh, stacked, times):
        """Every leaf of ``tree`` gathered at use ``times`` times (its
        sub-module's chunk where that is tensor-parallel), each gradient
        reduced once in training."""
        for rel, leaf, s in _walk_leaves(tree, sh):
            full = _layer_shape(leaf, stacked)
            s = _layer_sharding(s, leaf.ndim, stacked)
            gs, kept = _at_use(s, kept_axes(p_sh, (*path, *rel), rules))
            shape = kept.shard_shape(full)
            over = tuple(a for e in gs.entries(len(full))
                         for a in _axes_of(e))
            if over and _mesh_size(mesh, over) > 1:
                t.coll_add("all-gather", math.prod(shape)
                           * leaf.element_size(), times)
            if train:
                for k, shp in reduce_plan(gs, shape, batch_axes):
                    t.coll_add(k, math.prod(shp) * leaf.element_size())

    def attention(dims, tp_m, kv_local, kv_len, times, *, first=False,
                  flash=False, cross=False):
        d, hd = dims.d_model, dims.head_dim
        hq = dims.n_heads // tp_m
        q_bwd = back - (1 if first else 0)     # the frames: no gradient
        t.mm("projections", tokens, d, hq * hd, times + q_bwd)
        if not (cross and decode):
            kv_rows = rows * (s_enc if cross else s_all)
            t.mm("projections", kv_rows, d, kv_local * hd, 2 * (times
                                                                + q_bwd))
        sq, sk = (1, kv_len) if decode else (_pad(s_all, qb),
                                             _pad(kv_len, kb))
        one = 2 * rows * hq * sq * sk * hd      # the scores, or the values
        t.add("attention", 2 * one * times
              + ((5 if flash else 4) * one if train else 0))
        t.mm("projections", tokens, hq * hd, d, times + back)

    def ffn(f_loc, times, last):
        n_in = 2 if cfg.ffn in ("swiglu", "geglu") else 1
        t.mm("ffn", tokens, cfg.d_model, f_loc, n_in * (times + back))
        t.mm("ffn", tokens, f_loc, cfg.d_model, times + back)
        if remat and last:
            t.remat_tail += 2 * tokens * f_loc * cfg.d_model

    def moe(path, times, last):
        """The MoE block (`nn.moe.apply_moe`): the router on every model
        rank, this rank's experts (or hidden-width chunk) on the buffer,
        the shared experts' chunk."""
        dims = cfg.moe_dims()
        e, fe, d = dims.n_experts, dims.d_ff, cfg.d_model
        ep_axes, ep_m = split(*path, "moe", "experts")
        _, ff_m = split(*path, "moe", "expert_ff")
        sh_axes, sh_m = split(*path, "moe", "shared")
        buf = rows * e * capacity(dims, s_all) * d      # (B, E, C, d)
        slots = buf // d // ep_m
        t.mm("router", tokens, d, e, times + back)
        t.mm("moe", slots, d, fe // ff_m, 2 * (times + back))
        t.mm("moe", slots, fe // ff_m, d, times + back)
        amax(times=times)                     # the buffer, whole
        amax(ep_m * ff_m, times)              # the hidden activation
        if ep_m > 1:        # the experts' outputs put together
            t.coll_add("all-gather", buf * cdt, times)
        if ff_m > 1:        # w_down row-parallel; the buffer's copy
            t.coll_add("all-reduce", buf * row_dt, times + (1 if train
                                                            else 0))
        copies = {ep_axes} if ep_m > 1 else set()
        if dims.n_shared:
            fs = fe * dims.n_shared // sh_m
            t.mm("moe", tokens, d, fs, 2 * (times + back))
            t.mm("moe", tokens, fs, d, times + back)
            if remat and last:
                t.remat_tail += 2 * tokens * fs * d
            amax(times=times)
            if sh_m > 1:
                t.coll_add("all-reduce", tokens * d * row_dt, times)
                copies.add(sh_axes)
        if train:           # x's input-gradient sums, one a model group
            t.coll_add("all-reduce", tokens * d * row_dt, len(copies))
        if train and batch_group:
            for nbytes in (8, 8 * e, 8 * e, 8, 8):
                t.coll_add("all-reduce", nbytes, times)

    def mixer(path, bparams, bt, times, last):
        """A recurrent mixer (`_mixer_flops`), split over "model" where
        `tp_axes` says: the SSM's stored in_proj chunks all-gathered (their
        gradient reduce-scattered), its gated norm's float64 sum of squares
        and the conv weights' gradient summed; the RG-LRU's gates
        reduce-scattered (their gradient all-gathered) and Lambda's and the
        gate biases' gradients summed; out_proj row-parallel and the
        input's one `copy_to_model`, as attention."""
        m = split(*path, bt)[1]
        fwd, bwd = _mixer_flops(cfg, bt, rows, s_all, train, decode, m)
        t.add("mixer", fwd * times + bwd)
        amax(times=times)
        amax(m, times)
        d = cfg.d_model
        if bt == "ssm":
            sd = cfg.ssm_dims()
            if remat and last:
                t.remat_tail += 2 * tokens * sd.d_inner // m * d
            if not decode:
                t.xla_only += _xla_ssd_extra(cfg, rows, s_all, m, runs, train)
        if m == 1:
            return
        t.coll_add("all-reduce", tokens * d * row_dt, times)    # out_proj
        if bt == "ssm":
            io = 2 * sd.d_inner + 2 * sd.n_groups * sd.d_state + sd.n_heads
            t.coll_add("all-gather", tokens * io * cdt, times)
            t.coll_add("all-reduce", tokens * 8, times + (1 if train
                                                          else 0))
            summed = ("conv_w", "conv_b")
            if train:       # float64 under QAT
                t.coll_add("reduce-scatter", tokens * io // m * row_dt)
        else:
            r = cfg.rglru_dims().d_rnn
            t.coll_add("reduce-scatter", tokens * r // m * row_dt,
                       2 * times)
            summed = ("b_a", "b_x", "lam")
            if train:       # the gates' gradient (float32 under QAT)
                t.coll_add("all-gather", tokens * r * (4 if qat else cdt), 2)
        if train:       # the input's copy; the whole leaves' gradients
            t.coll_add("all-reduce", tokens * d * row_dt)
            for key in summed:
                leaf = bparams[bt][key]
                t.coll_add("all-reduce", math.prod(_layer_shape(
                    leaf, path[0] != "tail")) * leaf.element_size())

    def attn_split(path, bparams, bsh, sub, dims, stacked, times):
        """(model ranks, K/V heads a rank computes) of the attention (or
        cross-attention) ``sub`` of a block, and its tensor-parallel
        collectives: wo's all-reduce, in training the shared inputs'
        gradient sums (``sub``'s one, cross-attention's encoder output's
        too) and a replicated K/V weight's gradient."""
        axes, tp_m = split(*path, sub)
        kv_local, replicated = dims.n_kv_heads, False
        if tp_m > 1:
            wk, wk_s = bparams[sub]["wk"], bsh[sub]["wk"]
            if set(axes) & {a for e in wk_s.entries(wk.ndim)
                            for a in _axes_of(e)}:
                kv_local = dims.n_kv_heads // tp_m
            elif not decode:  # the K/V heads this rank's heads read
                replicated = True
                g = dims.n_heads // dims.n_kv_heads
                kv_local = max(1, dims.n_heads // tp_m // g)
            t.coll_add("all-reduce", tokens * cfg.d_model * row_dt, times)
            if train:       # the column products' shared input(s)
                t.coll_add("all-reduce", tokens * cfg.d_model * row_dt)
                if sub == "xattn":
                    t.coll_add("all-reduce",
                               rows * s_enc * cfg.d_model * row_dt)
                for key in ("wk", "wv", "bk", "bv") if replicated else ():
                    if key in bparams[sub]:
                        leaf = bparams[sub][key]
                        t.coll_add("all-reduce", math.prod(_layer_shape(
                            leaf, stacked)) * leaf.element_size())
        return tp_m, kv_local

    def block(path, bparams, bsh, bt, stacked, times, *, encoder=False,
              first=False, layer_cache=None, last=True):
        """One block's products and collectives; ``last``: its last
        product is the last of a checkpointed layer body (remat's tail)."""
        gather_at_use(path, bparams, bsh, stacked, times)
        if bt in RECURRENT:
            mixer(path, bparams, bt, times, last)
        else:
            dims = cfg.enc_attn_dims() if encoder \
                else cfg.attn_dims(bt == "local")
            tp_m, kv_local = attn_split(path, bparams, bsh, "attn", dims,
                                        stacked, times)
            kv_len = layer_cache["k"].shape[-3] if decode else s_all
            attention(dims, tp_m, kv_local, kv_len, times, first=first,
                      flash=train and step_cfg.flash and not encoder
                      and dims.softcap == 0)
            amax(times=3 * times)
            amax(tp_m, times)
            if "xattn" in bparams:
                xd = cfg.enc_attn_dims()
                x_m, x_kv = attn_split(path, bparams, bsh, "xattn", xd,
                                       stacked, times)
                attention(xd, x_m, x_kv,
                          layer_cache["xk"].shape[-3] if decode else s_enc,
                          times, cross=True)
                amax(times=3 * times)
                amax(x_m, times)
        if bt == "ssm":
            return
        if "moe" in bparams:
            moe(path, times, last)
            return
        _, mlp_m = split(*path, "mlp")
        ffn(cfg.d_ff // mlp_m, times, last)
        amax(times=times)
        amax(mlp_m, times)
        if mlp_m > 1:
            t.coll_add("all-reduce", tokens * cfg.d_model * row_dt, times)
            if train:
                t.coll_add("all-reduce", tokens * cfg.d_model * row_dt)

    def encoder_block(first):
        """An encoder layer: its blocks' products over the frames."""
        nonlocal tokens, s_all
        dec = tokens, s_all
        tokens, s_all = rows * s_enc, s_enc
        try:
            block(("enc_blocks",), params["enc_blocks"], p_sh["enc_blocks"],
                  "attn", True, runs, encoder=True, first=first)
        finally:
            tokens, s_all = dec

    def forward_once(fn) -> int:
        """The products of one forward of ``fn(times)`` (a block)."""
        nonlocal t
        kept, counts = t, []
        for times in (1, 2):
            t = _Tally()
            fn(times)
            counts.append(sum(t.flops.values()))
        t = kept
        return counts[1] - counts[0]

    def k3_scales():
        """K3's per-column MAX of every unit whose reduced dims are
        sharded (`models.lm._global_amax_row`)."""
        for top in ("blocks", "enc_blocks", "tail"):
            if top not in params:
                continue
            tops = [(None, params[top], p_sh[top])] if top == "enc_blocks" \
                else [(g, params[top][g], p_sh[top][g]) for g in params[top]]
            for _, blk, bsh in tops:
                for unit in block_matmuls(blk):
                    sub, key = unit.split("/")
                    w, s = blk[sub][key], bsh[sub][key]
                    lead = (top != "tail") + is_expert_unit(unit)
                    axes = tuple(a for e in s.entries(w.ndim)[lead:-1]
                                 for a in _axes_of(e))
                    if axes and _mesh_size(mesh, axes) > 1:
                        loc = s.shard_shape(w.shape)
                        t.coll_add("all-reduce", math.prod(loc[:lead])
                                   * loc[-1] * w.element_size())

    head = "embed" if cfg.tie_embeddings else "lm_head"
    for _ in range(n_micro):
        if qat:
            k3_scales()
        _, v_m = split("embed")
        gather_at_use(("embed",), params["embed"], p_sh["embed"], False, 1)
        if v_m > 1:
            t.coll_add("all-reduce", rows * s_tok * cfg.d_model * cdt)
        if cfg.encoder_decoder and not decode:
            for r in range(cfg.n_enc_layers):
                # the frames need no gradient: the first layer's
                # projections skip theirs, unless a norm's parameters
                # stand between
                encoder_block(r == 0 and not params["enc_blocks"]["ln1"])
            gather_at_use(("enc_norm",), params["enc_norm"],
                          p_sh["enc_norm"], False, 1)
        for _r in range(model.n_rep):
            for i, bt in enumerate(cfg.pattern):
                g = f"g{i}"
                block(("blocks", g), params["blocks"][g], p_sh["blocks"][g],
                      bt, True, runs, layer_cache=None if not decode
                      else {k: v[0] for k, v in cache["groups"][g].items()},
                      last=i == len(cfg.pattern) - 1)
        for j in range(model.n_tail):
            name = f"t{j}"
            tail = functools.partial(
                block, ("tail", name), params["tail"][name],
                p_sh["tail"][name], cfg.pattern[j], False,
                layer_cache=None if not decode else cache["tail"][name],
                last=False)
            tail(runs)
            if remat:       # the JAX package runs the tail unchecked
                t.remat_tail += forward_once(tail)
        gather_at_use(("final_norm",), params["final_norm"],
                      p_sh["final_norm"], False, 1)
        _, h_m = split(head)
        gather_at_use((head,), params[head], p_sh[head], False, 1)
        t.mm("readout", tokens, cfg.d_model, cfg.padded_vocab // h_m,
             1 + back)
        if train:
            if h_m > 1:     # the read-out's input gradient (float64
                # under QAT); the loss's max, float64 sum and label
                t.coll_add("all-reduce", tokens * cfg.d_model * row_dt)
                for nbytes in (4, 8, 4):
                    t.coll_add("all-reduce", rows * s_tok * nbytes)
            if batch_group:
                t.coll_add("all-reduce", 8, 2)
    if decode:
        store = TR.cache_shardings(model, cell, mesh, rules,
                                   kv_seq_shard=kv_seq_shard)
        compute = TR.compute_cache_shardings(cache, mesh, rules)
        leaves = flatten_with_names(cache)
        for src, dst in ((store, compute), (compute, store)):
            src, dst = flatten_with_names(src), flatten_with_names(dst)
            for name, x in leaves.items():
                a, b = src[name], dst[name]
                es, ed = a.entries(x.ndim), b.entries(x.ndim)
                dims = [d for d in range(x.ndim)
                        if es[d] is not None and es[d] != ed[d]]
                over = tuple(ax for d in dims for ax in _axes_of(es[d]))
                if over and _mesh_size(mesh, over) > 1:
                    shape = list(a.shard_shape(x.shape))
                    for d in dims:
                        shape[d] *= _mesh_size(mesh, es[d])
                    t.coll_add("all-gather", math.prod(shape)
                               * x.element_size())
    if train and mesh.size > 1:
        t.coll_add("all-reduce", 8 * len(tree_leaves(params)))
    return t.result()


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             qat: bool = True, with_comp: bool = True, remat: bool = True,
             q_block: int = 512, kv_block: int = 512,
             rules_override: Optional[dict] = None, flash: bool = False,
             grad_accum: int = 1, kv_seq_shard: bool = False,
             moe_local_dispatch: bool = False, tag: str = "") -> dict:
    """The cell's manifest (module docstring). The keywords are the JAX
    package's step knobs (its CLI flags); ``rules_override``: logical axis
    -> mesh axes (None: replicated) replacing `DEFAULT_RULES`' entries.
    ``with_comp`` changes only the comp tree's bytes (an argument);
    ``moe_local_dispatch`` is recorded and changes nothing (the port's
    dispatch is local either way)."""
    from repro_torch.configs import (
        SHAPES,
        cell_is_runnable,
        get_config,
        skip_reason,
    )
    from repro_torch.distributed.sharding import DEFAULT_RULES
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
        "batch": shape.batch, "qat": qat, "with_comp": with_comp,
        "remat": remat, "flash": flash, "grad_accum": grad_accum,
        "q_block": q_block, "kv_block": kv_block,
        "kv_seq_shard": kv_seq_shard,
        "moe_local_dispatch": moe_local_dispatch,
        "rules_override": rules_override or {}, "tag": tag,
    }
    if not cell_is_runnable(arch, shape_name):
        result["status"] = "skipped"
        result["skip_reason"] = skip_reason(arch, shape_name)
        return result

    rules = DEFAULT_RULES.replace(**rules_override) if rules_override \
        else DEFAULT_RULES
    step_cfg = TR.StepConfig(qat=qat, with_comp=with_comp, remat=remat,
                             q_block=q_block, kv_block=kv_block, flash=flash,
                             grad_accum=grad_accum)
    model = build_lm(cfg)
    guard: list = []
    per_device = {}
    if shape.kind == "train":
        state = TR.abstract_train_state(model)
        state_sh = TR.train_state_shardings(model, mesh, rules,
                                            guard_report=guard)
        per_device["params"] = device_bytes(state["params"],
                                            state_sh["params"])
        per_device["opt"] = device_bytes(state["opt"], state_sh["opt"])
        if with_comp:
            per_device["comp"] = device_bytes(
                TR.comp_abstract(model),
                TR.comp_shardings(model, mesh, rules, guard_report=guard))
        specs = TR.batch_specs(cfg, shape)
        per_device["batch"] = device_bytes(
            specs, TR.batch_shardings(specs, mesh, rules))
    elif shape.kind == "prefill":
        per_device["params"] = device_bytes(
            TR.abstract_serve_params(model),
            TR.make_param_shardings(model.spec, mesh, rules,
                                    guard_report=guard))
        specs = TR.batch_specs(cfg, shape)
        per_device["batch"] = device_bytes(
            specs, TR.batch_shardings(specs, mesh, rules))
    else:  # decode
        per_device["params"] = device_bytes(
            TR.abstract_serve_params(model),
            TR.make_param_shardings(model.spec, mesh, rules,
                                    guard_report=guard))
        per_device["cache"] = device_bytes(
            TR.decode_cache_specs(model, shape),
            TR.cache_shardings(model, shape, mesh, rules, guard_report=guard,
                               kv_seq_shard=kv_seq_shard))
        tokens = {"tokens": torch.empty((shape.batch, 1), dtype=torch.int32,
                                        device="meta")}
        per_device["batch"] = device_bytes(
            tokens, TR.batch_shardings(tokens, mesh, rules))
    per_device["total"] = sum(per_device.values())
    gathered = gathered_peak_bytes(model, shape.kind, mesh, rules)
    costs = step_costs(model, mesh, rules, shape.kind, shape.batch,
                       shape.seq, step_cfg, kv_seq_shard=kv_seq_shard)
    result.update({
        "status": "ok",
        "layout_s": round(time.time() - t0, 3),
        "per_device_bytes": per_device,
        "argument_size_in_bytes": per_device["total"],
        "gathered_peak_bytes": gathered,
        "per_device_peak_bytes": per_device["total"] + gathered,
        "flops": costs["flops"],
        "collectives": costs["collectives"],
        "guard_report": guard,
        "n_devices": mesh.size,
        "hlo_only": {"fields": list(HLO_ONLY), "why": HLO_ONLY_REASON},
    })
    return result


def cell_path(arch: str, shape: str, multi_pod: bool,
              out_dir: Path = OUT_DIR, tag: str = "") -> Path:
    from repro_torch.launch.mesh import production_mesh_layout

    sizes, _ = production_mesh_layout(multi_pod=multi_pod)
    suffix = f"__{tag}" if tag else ""
    return Path(out_dir) / (f"{arch}__{shape}__{'x'.join(map(str, sizes))}"
                            f"{suffix}.json")


def parse_rules(text: str) -> dict:
    """``"heads=None,embed=data+model"`` -> {"heads": None, "embed":
    ("data", "model")} (the JAX CLI's ``--rules``)."""
    out = {}
    for kv in filter(None, text.split(",")):
        k, v = kv.split("=")
        out[k] = (None if v in ("None", "none", "")
                  else tuple(v.split("+")) if "+" in v else v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape at both production meshes")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--no-qat", action="store_true")
    ap.add_argument("--no-comp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--q-block", type=int, default=512)
    ap.add_argument("--kv-block", type=int, default=512)
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--kv-seq", action="store_true")
    ap.add_argument("--moe-local", action="store_true",
                    help="the MoE's local dispatch (recorded; the port's "
                    "dispatch is local either way)")
    ap.add_argument("--remat-save-qat", action="store_true",
                    help="refused: changes only the activations' bytes, "
                    "which the dry run does not count")
    ap.add_argument("--tag", default="")
    ap.add_argument("--rules", default="",
                    help="logical=mesh overrides, e.g. embed=model,heads=None")
    args = ap.parse_args(argv)
    if args.remat_save_qat:
        ap.error("--remat-save-qat changes only the activations' bytes, "
                 "which the dry run does not count yet")
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    knobs = dict(qat=not args.no_qat, with_comp=not args.no_comp,
                 remat=not args.no_remat, q_block=args.q_block,
                 kv_block=args.kv_block, flash=args.flash,
                 grad_accum=args.grad_accum, kv_seq_shard=args.kv_seq,
                 moe_local_dispatch=args.moe_local,
                 rules_override=parse_rules(args.rules) or None,
                 tag=args.tag)

    if args.all:
        from repro_torch.configs import ALL_ARCHS, SHAPES

        counts = {"ok": 0, "skipped": 0}
        for arch in ALL_ARCHS:
            for shape in SHAPES:
                for mp in (False, True):
                    result = run_cell(arch, shape, mp, **knobs)
                    path = cell_path(arch, shape, mp, out_dir, args.tag)
                    path.write_text(json.dumps(result, indent=2))
                    counts[result["status"]] += 1
                    print(f"{result['status']:7s} {path.name}", flush=True)
        print(json.dumps(counts))
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    result = run_cell(args.arch, args.shape, args.multi_pod, **knobs)
    path = cell_path(args.arch, args.shape, args.multi_pod, out_dir,
                     args.tag)
    path.write_text(json.dumps(result, indent=2))
    print(json.dumps({k: v for k, v in result.items()
                      if k != "guard_report"}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
