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

The JAX package's mesh, sharding and MoE-dispatch machinery (``mesh=``,
``rules=``, ``moe_local_dispatch=``, the ``abstract_*``, ``*_shardings``
and ``cache_axes`` helpers) lays a step out over a device mesh; it raises
`NotImplementedError` naming ROADMAP.md item 10.

    python -m repro_torch.launch.train --arch olmo-1b --steps 50 \\
        --plan-out BASE [--ckpt-dir DIR] [--device cpu]
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch._device import (
    DEFAULT_DEVICE,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.nn.layers import QuantConfig
from repro_torch.nn.spec import init_params
from repro_torch.optim.optimizers import Optimizer, adamw, apply_updates

WHISPER_DECODER_LEN = 448  # whisper's decoder context (enc length = seq_len)

MESH_NOT_PORTED = ("ROADMAP.md Queue 1 item 10, 'Multi-device, "
                   "checkpointing, launch'")


def _mesh_not_ported(what: str):
    return NotImplementedError(f"{what} (device meshes and shardings) is not "
                               f"ported yet: {MESH_NOT_PORTED}")


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


def make_train_step(model, step_cfg: StepConfig, mesh=None, rules=None,
                    moe_local_dispatch: bool = False) -> Callable:
    """train_step(state, batch[, comp]) -> (state, metrics). ``state`` is
    {"params", "opt"}, ``batch`` {"tokens", "labels"[, "loss_mask",
    "prefix_embeds", "enc_embeds"]} tensors on the params' device; metrics
    are 0-d tensors (``loss``, ``ce``, ``lb_loss``, ``z_loss``)."""
    if mesh is not None or rules is not None:
        raise _mesh_not_ported("make_train_step(mesh=, rules=)")
    if moe_local_dispatch:
        raise _mesh_not_ported("make_train_step(moe_local_dispatch=True)")
    optimizer = make_optimizer(step_cfg)
    qcfg = step_cfg.qcfg
    policy = "save_qat" if step_cfg.remat_save_qat else None

    def loss_fn(params, batch, comp):
        return model.loss(params, batch, qcfg=qcfg, comp=comp,
                          remat=step_cfg.remat, q_block=step_cfg.q_block,
                          kv_block=step_cfg.kv_block,
                          use_flash=step_cfg.flash, remat_policy=policy)

    n_micro = step_cfg.grad_accum

    def loss_grad(params, batch, comp):
        if n_micro <= 1:
            return _value_and_grad(loss_fn, params, batch, comp)
        b = batch["tokens"].shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} is not a multiple of grad_accum "
                             f"{n_micro}")
        g_acc = loss = metrics = None
        for i in range(n_micro):
            mb = {k: v.reshape(n_micro, b // n_micro, *v.shape[1:])[i]
                  for k, v in batch.items()}
            (l_i, m_i), g = _value_and_grad(loss_fn, params, mb, comp)
            if g_acc is None:
                g_acc, loss, metrics = g, l_i, m_i
            else:
                g_acc = tree_map(torch.add, g_acc, g)
                loss = loss + l_i
                metrics = {k: metrics[k] + m_i[k] for k in metrics}
        scale = 1.0 / n_micro
        return ((loss * scale, {k: v * scale for k, v in metrics.items()}),
                tree_map(lambda x: x * scale, g_acc))

    def step(state, batch, comp):
        (loss, metrics), grads = loss_grad(state["params"], batch, comp)
        updates, opt = optimizer.update(grads, state["opt"], state["params"])
        params = apply_updates(state["params"], updates)
        return {"params": params, "opt": opt}, dict(metrics, loss=loss)

    if step_cfg.with_comp:
        return step
    return lambda state, batch: step(state, batch, None)


def make_prefill_step(model, step_cfg: StepConfig, mesh=None,
                      rules=None) -> Callable:
    """prefill_step(params, batch) -> logits (inference forward at length
    P + S, no QAT; ``batch`` as the train step's, no labels)."""
    if mesh is not None or rules is not None:
        raise _mesh_not_ported("make_prefill_step(mesh=, rules=)")

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch["tokens"],
                                  prefix_embeds=batch.get("prefix_embeds"),
                                  enc_embeds=batch.get("enc_embeds"),
                                  qcfg=QuantConfig.off(), remat=False,
                                  q_block=step_cfg.q_block,
                                  kv_block=step_cfg.kv_block)
        return logits

    return prefill_step


def make_serve_step(model, step_cfg: StepConfig, mesh=None,
                    rules=None) -> Callable:
    """serve_step(params, cache, tokens) -> (logits, cache): one decode
    step."""
    if mesh is not None or rules is not None:
        raise _mesh_not_ported("make_serve_step(mesh=, rules=)")

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens,
                                 qcfg=QuantConfig.off())

    return serve_step


# ================================================================== state


def init_train_state(model, step_cfg: StepConfig, seed: int = 0, *,
                     device=DEFAULT_DEVICE) -> dict:
    """{"params": seeded init on ``device``, "opt": the optimizer's state}."""
    params = init_params(seed, model.spec, device)
    return {"params": params, "opt": make_optimizer(step_cfg).init(params)}


def _sharding_helper(name: str):
    def helper(*args, **kwargs):
        raise _mesh_not_ported(name)

    helper.__name__ = name
    helper.__doc__ = (f"The JAX package's ``{name}``: raises "
                      "`NotImplementedError` (ROADMAP.md item 10).")
    return helper


abstract_train_state = _sharding_helper("abstract_train_state")
abstract_serve_params = _sharding_helper("abstract_serve_params")
comp_abstract = _sharding_helper("comp_abstract")
train_state_shardings = _sharding_helper("train_state_shardings")
comp_shardings = _sharding_helper("comp_shardings")
batch_shardings = _sharding_helper("batch_shardings")
cache_axes = _sharding_helper("cache_axes")
cache_shardings = _sharding_helper("cache_shardings")
moe_dispatch_constraint = _sharding_helper("moe_dispatch_constraint")


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


def decode_cache_specs(model, shape, dtype=torch.bfloat16) -> dict:
    """Abstract decode cache (meta tensors) of a decode cell: for the
    encoder-decoder family a self-attention cache bounded by the decoder
    context and cross-attention K/V over ``shape.seq`` frames."""
    if model.cfg.encoder_decoder:
        return model.cache_spec(shape.batch, WHISPER_DECODER_LEN, dtype,
                                cross_len=shape.seq)
    return model.cache_spec(shape.batch, shape.seq, dtype)


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
