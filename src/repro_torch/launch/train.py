"""Train / prefill / serve step factories and the train launcher (port of
`repro.launch.train`).

`make_train_step` builds the LM QAT step: the causal LM loss
(`repro_torch.models.lm.LMModel.loss`) on the fake-quant forward, whose
weights take one grouped K3 launch a forward with the straight-through
backward, then global-norm clipping and AdamW (`make_optimizer`). With
``grad_accum`` > 1 the batch is split into that many micro-batches whose
gradients, losses and metrics are summed in float32 in order and scaled
by 1 / n, the JAX package's scan written as a loop. The step runs on the
device its tensors lie on.

The correctly rounded products of the QAT forward (`exact_matmul`) keep
no float64 copies of their operands for the backward, which sums in
float64 and rounds once: on the H100 a float64 GEMM runs on the tensor
cores, and a float32 backward (the JAX package's) took 3-4% more time a
step (PERF.md).

A batch may hold ``enc_embeds`` (the encoder-decoder family's frame
embeddings) or ``prefix_embeds`` (a VLM's patch embeddings, put in front
of the tokens; the loss scores the token positions). `batch_specs` and
`decode_cache_specs` give a cell's abstract batch and decode cache (meta
tensors; whisper's decoder context is `WHISPER_DECODER_LEN`).

**Over a mesh** (``mesh=``, ``rules=``; `repro_torch.distributed
.sharding`): every rank calls the step with its own slices of the state,
the comp tree, the serve params and the decode cache, each on its
sharding (`train_state_shardings`, `comp_shardings`,
`make_param_shardings`, `cache_shardings`), and with the whole batch, of
which it takes its rows (`batch_sharding`'s guard: a batch that does not
divide the batch axes replicates). FSDP a layer: the model gathers each
block's parameters where it runs that block and frees them after it
(`repro_torch.distributed.sharding.layer_gathering`), the embedding and
the read-out at use; under remat the backward's recompute gathers the
block again, so the full tensors alive at once are about one block's
(with ``remat=False`` autograd keeps every gathered block for the
backward, the whole model). Under QAT the one grouped K3 launch runs on
this rank's slices with the gathered weights' per-column scales (a MAX
over the ranks that hold the other rows), and the block gathers the
fake-quantized slices. A gathered tensor's gradient comes back as this
rank's slice of the global batch's (`reduce_to_slice`: a reduce-scatter
over the batch ranks); AdamW updates the slices, the global-norm clip
summing the slices' float64 squares over the mesh
(`sharded_global_norm`). A step's metrics carry ``gathered_peak_bytes``,
the most bytes of gathered tensors and full gradients it held at once
(`gathered_bytes`); the prefill and serve steps' peak is read with
`gathered_bytes` after them. Where the
JAX package's partitioner reduces over the global batch, the step does
too (`batch_reduction`): the activation fake-quant's amax (MAX), the
loss's sum and count and the MoE auxiliary losses' token sums.

**Tensor-parallel compute over "model"**, as the JAX package's
partitioner divides the meshed step: the rows split over ("pod", "data")
(`batch_sharding`), and the ranks of one model group share them
and split the features. A decoder block's attention (heads), its dense FFN
(hidden width) and the token table and read-out (vocabulary) compute this
rank's share where the layout shards that dim over "model" (after the
divisibility guard; `repro_torch.distributed.sharding.tp_axes`): the
block keeps its model chunk when gathered, wq/wk/wv and w_gate/w_up run
column-parallel, wo and w_down row-parallel (their float64 partial sums
all-reduced and rounded once under QAT), the embedding is a masked lookup
summed over "model", the loss a vocabulary-parallel cross-entropy, and
each activation split over "model" takes its amax over those ranks too.
K/V heads that the guard replicates are computed, on each rank, for the
query heads it holds. The MoE splits as the JAX partitioner divides it
(`repro_torch.nn.moe`): each model rank runs its chunk of the experts
("expert" -> "model") on the dispatch buffer of the rows its model group
shares and the ranks all-gather the experts' outputs, or, with
``expert=None, moe_ff=model``, every expert at its chunk of the hidden
width (column- and row-parallel); shared experts split their hidden width
as the dense FFN. ``--rules
heads=None,mlp=None,vocab=None,kv_heads=None,inner=None`` gives the
storage-only step (``expert=None`` runs every expert whole on each rank,
stored over "data" alone). Every rank scatters its rows into the
dispatch buffer locally and slices its experts, so the step is the
same with or without ``moe_local_dispatch`` (its
`moe_dispatch_constraint` is an identity on values). A step's losses
are the global batch's; a prefill step returns the rank's block of the
logits on `logits_sharding` (its rows, its vocabulary chunk), a serve
step that block and its slice of the new cache. On a mesh of one process
(1 x 1) nothing is gathered, split or reduced and the step is the
unmeshed one, bit for bit.

The recurrent mixers, an encoder's blocks and cross-attention split over
"model" too, as the JAX partitioner divides them where the layout shards
their `inner` channels or heads there: the RG-LRU by channels (in_proj and
gate_proj column-parallel, w_a and w_x row-parallel with their gates
reduce-scattered, out_proj row-parallel), Mamba-2's SSM by heads (in_proj
column-parallel on its stored chunk, the chunks all-gathered and read by
heads; the gated norm's sum of squares summed over the ranks; out_proj
row-parallel), an encoder layer's attention and FFN and a decoder layer's
cross-attention as a decoder layer's attention (`repro_torch.nn.ssm`,
`repro_torch.nn.rglru`, `repro_torch.nn.transformer`). A serve step
computes the recurrent caches on the rank's channels or heads (the SSM's
conv history whole) and the cross K/V on its K/V heads
(`compute_cache_shardings`). The loss is one function whether the
vocabulary splits or not (`repro_torch.distributed.sharding
.vocab_parallel_nll`: its exponentials summed in float64), so a meshed
step's gradients are the unmeshed step's bits but for the rounding of
that sum. `abstract_train_state`, `abstract_serve_params` and `comp_abstract` are
meta tensors.

    python -m repro_torch.launch.train --arch olmo-1b --steps 50 \\
        --plan-out BASE [--ckpt-dir DIR] [--device cpu]
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch._device import (
    DEFAULT_DEVICE,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    BatchReduce,
    NamedSharding,
    PartitionSpec,
    ShardingRules,
    _axes_of,
    _mesh_size,
    LayerGather,
    batch_reduction,
    batch_sharding,
    gathered_bytes,
    layer_gathering,
    make_param_shardings,
    reset_gathered_peak,
    reshard_tree,
    sharded_global_norm,
    shardings_from_axes_tree,
)
from repro_torch.nn.layers import QuantConfig
from repro_torch.nn.spec import abstract_params, init_params
from repro_torch.optim.optimizers import Optimizer, adamw, apply_updates

WHISPER_DECODER_LEN = 448  # whisper's decoder context (enc length = seq_len)


# ===================================================================== steps


@dataclasses.dataclass(frozen=True)
class StepConfig:
    qat: bool = True            # paper setup: int8 QAT on all matmuls
    with_comp: bool = True      # thread masks/codebooks through the step
    remat: bool = True
    q_block: int = 512
    kv_block: int = 512
    lr: float = 3e-4
    weight_decay: float = 0.01
    grad_accum: int = 1         # microbatching: divides activation memory
    flash: bool = False         # flash-attention backward (nn/flash.py)
    remat_save_qat: bool = False  # the port keeps them either way

    @property
    def qcfg(self) -> QuantConfig:
        return QuantConfig(enabled=self.qat)


def make_optimizer(step_cfg: StepConfig) -> Optimizer:
    return adamw(step_cfg.lr, weight_decay=step_cfg.weight_decay,
                 max_grad_norm=1.0)


def _value_and_grad(loss_fn, params, batch, comp):
    """((loss, metrics), grads) of ``loss_fn(params, batch, comp)``; grads
    have the structure of ``params`` (zeros for a leaf the loss does not
    read)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, iter(leaves)), batch,
                            comp)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_unflatten(params, iter(grads)))


def moe_dispatch_constraint(mesh, rules: ShardingRules = DEFAULT_RULES):
    """The dispatch-buffer hook of `repro_torch.nn.moe` for ``mesh``. In
    the JAX package it pins the (B, E, C, d) buffer's layout for the SPMD
    partitioner ('scatter': model-replicated, so the scatter is local;
    'expert': E over the expert axis, a local slice). Here every model
    rank already scatters its rows locally and slices its own experts
    (`apply_moe`'s expert parallelism), so the hook returns its tensor
    unchanged."""
    del mesh, rules

    def hook(t, kind):
        return t

    return hook


def _loss_fn(model, step_cfg: StepConfig):
    qcfg = step_cfg.qcfg
    policy = "save_qat" if step_cfg.remat_save_qat else None

    def loss_fn(params, batch, comp):
        return model.loss(params, batch, qcfg=qcfg, comp=comp,
                          remat=step_cfg.remat, q_block=step_cfg.q_block,
                          kv_block=step_cfg.kv_block,
                          use_flash=step_cfg.flash, remat_policy=policy)

    return loss_fn


def _micro_batches(batch, n_micro: int) -> list:
    if n_micro <= 1:
        return [batch]
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} is not a multiple of grad_accum "
                         f"{n_micro}")
    return [{k: v.reshape(n_micro, b // n_micro, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n_micro)]


def _accumulate(parts):
    """((loss, metrics), grads) of the micro-batches, summed in order and
    scaled by 1 / n as the JAX package's scan; ``parts`` yields each
    micro-batch's ((loss, metrics), grads)."""
    g_acc = loss = metrics = None
    for (l_i, m_i), g in parts:
        if g_acc is None:
            g_acc, loss, metrics = g, l_i, m_i
        else:
            g_acc = tree_map(torch.add, g_acc, g)
            loss = loss + l_i
            metrics = {k: metrics[k] + m_i[k] for k in metrics}
    return (loss, metrics), g_acc


def _scaled(acc, n_micro: int):
    (loss, metrics), grads = acc
    if n_micro <= 1:
        return acc
    scale = 1.0 / n_micro
    return ((loss * scale, {k: v * scale for k, v in metrics.items()}),
            tree_map(lambda x: x * scale, grads))


def make_train_step(model, step_cfg: StepConfig, mesh=None,
                    rules: Optional[ShardingRules] = None,
                    moe_local_dispatch: bool = False) -> Callable:
    """train_step(state, batch[, comp]) -> (state, metrics). ``state`` is
    {"params", "opt"}, ``batch`` {"tokens", "labels"[, "loss_mask",
    "prefix_embeds", "enc_embeds"]} tensors on the params' device; metrics
    are 0-d tensors (``loss``, ``ce``, ``lb_loss``, ``z_loss``). With
    ``mesh``: the state and comp are this rank's slices (module
    docstring), ``rules`` default `DEFAULT_RULES`; ``moe_local_dispatch``
    sets `moe_dispatch_constraint`'s hook while the step runs."""
    if mesh is not None:
        return _meshed_train_step(model, step_cfg, mesh,
                                  DEFAULT_RULES if rules is None else rules,
                                  moe_local_dispatch)
    optimizer = make_optimizer(step_cfg)
    loss_fn = _loss_fn(model, step_cfg)
    n_micro = step_cfg.grad_accum

    def step(state, batch, comp):
        (loss, metrics), grads = _scaled(_accumulate(
            _value_and_grad(loss_fn, state["params"], mb, comp)
            for mb in _micro_batches(batch, n_micro)), n_micro)
        updates, opt = optimizer.update(grads, state["opt"], state["params"])
        params = apply_updates(state["params"], updates)
        return {"params": params, "opt": opt}, dict(metrics, loss=loss)

    if step_cfg.with_comp:
        return step
    return lambda state, batch: step(state, batch, None)


def _batch_axes(batch, mesh, rules) -> Tuple[str, ...]:
    """The mesh axes the batch's rows split over: () where it replicates
    (`batch_sharding`'s guard)."""
    b = next(iter(batch.values())).shape[0]
    return _axes_of(batch_sharding(mesh, (b,), rules).spec[0])


def _rows(batch, mesh, rules):
    """This rank's rows of every batch tensor."""
    return {k: batch_sharding(mesh, v.shape, rules).local(v)
            for k, v in batch.items()}


def _layer_gather(mesh, p_sh, batch_axes, rules) -> Optional[LayerGather]:
    """The step's `LayerGather` (its tensor-parallel units by ``rules``);
    None on a mesh of one process, where every slice is the whole tensor
    and nothing is gathered, split or reduced."""
    return None if mesh.size == 1 else LayerGather(p_sh, batch_axes,
                                                   rules=rules)


def _meshed_train_step(model, step_cfg, mesh, rules, moe_local_dispatch):
    from repro_torch.nn import moe

    p_sh = train_state_shardings(model, mesh, rules)["params"]
    optimizer = adamw(step_cfg.lr, weight_decay=step_cfg.weight_decay,
                      max_grad_norm=1.0,
                      norm_fn=lambda g: sharded_global_norm(g, p_sh))
    loss_fn = _loss_fn(model, step_cfg)
    hook = moe_dispatch_constraint(mesh, rules) if moe_local_dispatch \
        else None
    n_micro = step_cfg.grad_accum

    def step(state, batch, comp):
        micro = _micro_batches(batch, n_micro)
        axes = _batch_axes(micro[0], mesh, rules)
        group = mesh.group(axes)
        red = None if group is None else BatchReduce(mesh, axes)
        gather = _layer_gather(mesh, p_sh, axes, rules)
        token = None if hook is None else moe.set_dispatch_constraint(hook)
        reset_gathered_peak()
        try:
            with batch_reduction(red), layer_gathering(gather):
                (loss, metrics), grads = _accumulate(
                    _value_and_grad(loss_fn, state["params"],
                                    _rows(mb, mesh, rules), comp)
                    for mb in micro)
        finally:
            if token is not None:
                moe.reset_dispatch_constraint(token)
        (loss, metrics), grads = _scaled(((loss, metrics), grads), n_micro)
        updates, opt = optimizer.update(grads, state["opt"], state["params"])
        params = apply_updates(state["params"], updates)
        peak = torch.tensor(float(gathered_bytes()["peak"]),
                            dtype=torch.float64)
        return {"params": params, "opt": opt}, dict(
            metrics, loss=loss, gathered_peak_bytes=peak)

    if step_cfg.with_comp:
        return step
    return lambda state, batch: step(state, batch, None)


def make_prefill_step(model, step_cfg: StepConfig, mesh=None,
                      rules: Optional[ShardingRules] = None) -> Callable:
    """prefill_step(params, batch) -> logits (inference forward at length
    P + S, no QAT; ``batch`` as the train step's, no labels). With
    ``mesh``: ``params`` are this rank's slices on `make_param_shardings`
    and the logits its block on `logits_sharding` (its rows of the batch,
    its chunk of the vocabulary where the read-out is split)."""
    rules = DEFAULT_RULES if rules is None else rules
    p_sh = None if mesh is None else make_param_shardings(model.spec, mesh,
                                                          rules)

    @torch.no_grad()
    def prefill_step(params, batch):
        gather = None
        if mesh is not None:
            gather = _layer_gather(mesh, p_sh, (), rules)
            batch = _rows(batch, mesh, rules)
        reset_gathered_peak()
        with layer_gathering(gather):
            logits, _ = model.forward(
                params, batch["tokens"],
                prefix_embeds=batch.get("prefix_embeds"),
                enc_embeds=batch.get("enc_embeds"), qcfg=QuantConfig.off(),
                remat=False, q_block=step_cfg.q_block,
                kv_block=step_cfg.kv_block)
        return logits

    return prefill_step


def make_serve_step(model, step_cfg: StepConfig, mesh=None,
                    rules: Optional[ShardingRules] = None, *,
                    cache_shardings=None) -> Callable:
    """serve_step(params, cache, tokens) -> (logits, cache): one decode
    step. With ``mesh``: ``params`` are this rank's slices on
    `make_param_shardings`, ``tokens`` (B, 1) the whole batch; the cache
    is held on ``cache_shardings`` (the tree `cache_shardings` gives) or,
    without it, on its batch rows alone; the step returns its block of the
    logits on `logits_sharding` and its slice of the new cache. The step
    reads the cache on its rows and, where attention is tensor-parallel,
    its K/V heads (`compute_cache_shardings`); the held layout's other sharded
    dims (K/V heads the step does not split, or ``kv_seq_shard``'s
    sequence over "model": a storage layout) are gathered for the step
    and sliced again after it."""
    rules = DEFAULT_RULES if rules is None else rules
    p_sh = None if mesh is None else make_param_shardings(model.spec, mesh,
                                                          rules)
    rows_rules = ShardingRules((("batch", rules.lookup("batch")),))

    def layouts(cache, b):
        """(the layout the step computes on, the layout the cache is held
        on)."""
        axes = cache_axes(cache)

        def full(x, ax, s=None):
            if s is not None:
                shape = [d * _mesh_size(mesh, e)
                         for d, e in zip(x.shape, s.entries(x.ndim))]
            else:
                shape = list(x.shape)
                shape[ax.index("batch")] = b
            return torch.empty(shape, dtype=x.dtype, device="meta")

        store = cache_shardings
        shapes = tree_map(full, cache, axes) if store is None \
            else tree_map(full, cache, axes, store)
        if store is None:
            store = shardings_from_axes_tree(axes, shapes, mesh, rows_rules)
        return compute_cache_shardings(shapes, mesh, rules), store

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        if mesh is None:
            return model.decode_step(params, cache, tokens,
                                     qcfg=QuantConfig.off())
        compute, store = layouts(cache, tokens.shape[0])
        reset_gathered_peak()
        with layer_gathering(_layer_gather(mesh, p_sh, (), rules)):
            logits, new = model.decode_step(
                params, reshard_tree(cache, store, compute),
                batch_sharding(mesh, tokens.shape, rules).local(tokens),
                qcfg=QuantConfig.off())
        return logits, reshard_tree(new, compute, store)

    return serve_step


def compute_cache_shardings(cache, mesh,
                            rules: ShardingRules = DEFAULT_RULES):
    """The layout a meshed serve step computes a decode cache (full
    shapes, e.g. meta tensors) on: its batch rows; the K/V heads (``k``,
    ``v``, and cross-attention's ``xk`` / ``xv``) over the axes that split
    attention's heads where the heads and K/V heads share them (the guard
    replicating K/V heads that do not divide); the recurrent mixers'
    channels (the RG-LRU's ``h`` and ``conv``, the SSM's ``state`` by
    heads) over the axes of ``inner``, as the mixers split (guarded alike).
    The SSM's ``conv`` history keeps every channel: its x | B | C channels
    do not line up with the heads, and the step rebuilds it whole."""
    heads, inner = rules.lookup("heads"), rules.lookup("inner")
    batch = set(_axes_of(rules.lookup("batch")))
    compute_rules = ShardingRules((
        ("batch", rules.lookup("batch")),
        ("kv_heads", heads if heads is not None
         and rules.lookup("kv_heads") == heads else None),
        ("inner", None if batch & set(_axes_of(inner)) else inner)))

    def walk(node, ax, name=None):
        if isinstance(node, dict):
            return {k: walk(v, ax[k], None if k == "conv" and "state" in node
                            else k) for k, v in node.items()}
        if name in ("k", "v", "xk", "xv", "state", "h", "conv"):
            return ax
        return tuple(a if a == "batch" else None for a in ax)

    axes = walk(cache, cache_axes(cache))
    return shardings_from_axes_tree(axes, cache, mesh, compute_rules)


# ================================================================== state


def init_train_state(model, step_cfg: StepConfig, seed: int = 0, *,
                     device=DEFAULT_DEVICE) -> dict:
    """{"params": seeded init on ``device``, "opt": the optimizer's state}."""
    params = init_params(seed, model.spec, device)
    return {"params": params, "opt": make_optimizer(step_cfg).init(params)}


def abstract_train_state(model) -> dict:
    """The train state as meta tensors (no storage): {"params", "opt":
    {"step", "mu", "nu"}}."""
    params = abstract_params(model.spec)
    like = lambda t: tree_map(torch.empty_like, t)  # noqa: E731
    return {"params": params,
            "opt": {"step": torch.empty((), dtype=torch.int32,
                                        device="meta"),
                    "mu": like(params), "nu": like(params)}}


def train_state_shardings(model, mesh, rules: ShardingRules = DEFAULT_RULES,
                          guard_report=None) -> dict:
    p_sh = make_param_shardings(model.spec, mesh, rules,
                                guard_report=guard_report)
    return {"params": p_sh,
            "opt": {"step": NamedSharding(mesh, PartitionSpec()),
                    "mu": p_sh, "nu": p_sh}}


def abstract_serve_params(model):
    """Serve-time parameters in bfloat16 (meta tensors)."""
    return abstract_params(model.spec, torch.bfloat16)


def comp_abstract(model):
    from repro_torch.core.lm_compress import make_lm_comp_spec

    return abstract_params(make_lm_comp_spec(model))


def comp_shardings(model, mesh, rules: ShardingRules = DEFAULT_RULES,
                   guard_report=None):
    from repro_torch.core.lm_compress import make_lm_comp_spec

    return make_param_shardings(make_lm_comp_spec(model), mesh, rules,
                                guard_report=guard_report)


# ================================================================== inputs


def batch_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    """Abstract batch (meta tensors) of a train or prefill cell
    (`repro_torch.configs.base.Shape`). The encoder-decoder family takes
    ``shape.seq`` encoder frames (bfloat16) and at most
    `WHISPER_DECODER_LEN` decoder tokens; a VLM prefix takes the first
    ``prefix_len`` positions."""
    b, s = shape.batch, shape.seq

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    specs: Dict[str, torch.Tensor] = {}
    if cfg.encoder_decoder:
        s_dec = min(s, WHISPER_DECODER_LEN)
        specs["enc_embeds"] = meta((b, s, cfg.d_model), torch.bfloat16)
        specs["tokens"] = meta((b, s_dec), torch.int32)
        if shape.kind == "train":
            specs["labels"] = meta((b, s_dec), torch.int32)
        return specs
    s_tok = s - cfg.prefix_len
    if cfg.prefix_len:
        specs["prefix_embeds"] = meta((b, cfg.prefix_len, cfg.d_model),
                                      torch.bfloat16)
    specs["tokens"] = meta((b, s_tok), torch.int32)
    if shape.kind == "train":
        specs["labels"] = meta((b, s_tok), torch.int32)
    return specs


def batch_shardings(specs, mesh, rules: ShardingRules = DEFAULT_RULES):
    return {k: batch_sharding(mesh, v.shape, rules)
            for k, v in specs.items()}


def decode_cache_specs(model, shape, dtype=torch.bfloat16) -> dict:
    """Abstract decode cache (meta tensors) of a decode cell: for the
    encoder-decoder family a self-attention cache bounded by the decoder
    context and cross-attention K/V over ``shape.seq`` frames."""
    if model.cfg.encoder_decoder:
        return model.cache_spec(shape.batch, WHISPER_DECODER_LEN, dtype,
                                cross_len=shape.seq)
    return model.cache_spec(shape.batch, shape.seq, dtype)


_CACHE_AXES_BY_NAME = {
    "k": ("batch", None, "kv_heads", None),
    "v": ("batch", None, "kv_heads", None),
    "xk": ("batch", None, "kv_heads", None),
    "xv": ("batch", None, "kv_heads", None),
    "state": ("batch", "inner", None, None),
    "conv": ("batch", None, "inner"),
    "h": ("batch", "inner"),
    "pos": ("batch",),
}


def cache_axes(cache_spec, *, kv_seq_shard: bool = False):
    """Logical axes tree for a cache (layer-stacked leaves detected by
    rank: stacked leaves get a leading None for the layer axis).

    ``kv_seq_shard`` shards the K/V cache *sequence* dim over the model axis
    instead of the head dim: the fallback when kv_heads does not divide
    the model axis (MQA/GQA with few KV heads)."""
    kv_axes = (("batch", "kv_seq", None, None) if kv_seq_shard
               else ("batch", None, "kv_heads", None))
    by_name = dict(_CACHE_AXES_BY_NAME)
    for key in ("k", "v", "xk", "xv"):
        by_name[key] = kv_axes

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        base = by_name[name]
        extra = len(node.shape) - len(base)
        assert extra in (0, 1), (name, node.shape)
        return (None,) * extra + base

    return walk(cache_spec)


def cache_shardings(model, shape, mesh, rules: ShardingRules = DEFAULT_RULES,
                    dtype=torch.bfloat16, guard_report=None, *,
                    kv_seq_shard: bool = False):
    spec = decode_cache_specs(model, shape, dtype)
    axes = cache_axes(spec, kv_seq_shard=kv_seq_shard)
    return shardings_from_axes_tree(axes, spec, mesh, rules,
                                    guard_report=guard_report)


# ====================================================================== CLI


def main(argv: Optional[list] = None) -> int:
    """Thin train launcher over the pipeline: LM QAT base training (the
    pipeline's ``profile`` stage with ``train.qat_steps > 0``, built on this
    module's step factories) plus the energy model, saving the resulting
    `CompressionPlan` for a later ``compress`` / ``serve`` resume.

        python -m repro_torch.launch.train --arch olmo-1b --reduced \\
            --steps 50 --plan-out /tmp/olmo_plan --device cpu
    """
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=50,
                    help="QAT training steps before profiling")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params from a checkpoint directory "
                         "instead of initializing")
    ap.add_argument("--plan-out", default=None, metavar="BASE",
                    help="save the plan to BASE.json + BASE.npz")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: cuda; an error on a host "
                         "without CUDA)")
    args = ap.parse_args(argv)

    from repro_torch._device import resolve_device
    from repro_torch.pipeline.config import (
        PipelineConfig,
        TargetConfig,
        TrainStageConfig,
    )
    from repro_torch.pipeline.pipeline import Pipeline

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    cfg = PipelineConfig(
        target=TargetConfig(kind="lm", arch=args.arch, reduced=args.reduced,
                            seed=args.seed, batch_size=args.batch_size,
                            lr=args.lr, ckpt_dir=args.ckpt_dir),
        train=TrainStageConfig(qat_steps=args.steps, final_finetune_steps=0),
    )
    try:
        plan = Pipeline(cfg, device=device).run_until("energy_model",
                                                      verbose=True)
    except NotImplementedError as e:
        ap.error(str(e))
    print(json.dumps(plan.summary(), indent=2))
    if args.plan_out:
        json_path, npz_path = plan.save(args.plan_out)
        print(f"plan saved: {json_path} + {npz_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
