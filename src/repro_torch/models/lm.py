"""LM assembly: ArchConfig -> spec tree + forward / prefill / decode (port of
`repro.models.lm`).

Layers are grouped by the config's repeating block ``pattern``; each
pattern position's parameters are stacked over the repeat count (leaves
``(L, ...)`` under ``params["blocks"]["g<i>"]``, the JAX package's layout,
so its parameters carry across unchanged), and remainder layers are
unstacked ``tail`` blocks. The JAX package's ``lax.scan`` over the stack is
a Python loop over the layer axis here.

Under QAT (``qcfg.enabled``) a forward fake-quantizes every compressible
weight of every layer in one grouped K3 launch before its first layer
(`_fake_quant_units`): each stacked unit is one entry of the launch with
its layer axis as K3's candidate axis, so layer j's weight is
``fake_quant_weight(w[j], comp at j)``, the per-slice semantics of the
reference's scan. On the serve path (``comp_mode="serve"``) units with a
packed artifact run on the LUT GEMM (K2) and only the others take that
launch. The serving engine's chunked prefill (`LMModel.prefill_chunk`) and
its cache row shuffles (`gather_cache_rows`, `scatter_cache_rows`) follow
the same layer walk and make the same one K3 launch a call. In a meshed
step (`repro_torch.distributed.sharding.layer_gathering`) the parameters
are the rank's slices: the K3 launch runs on them with the gathered
weights' per-column scales (`_global_amax_row`, for the row-split leaves
too: wo, w_down, out_proj, w_a, w_x), and each block, the embedding, the
read-out and the norms are gathered where they are used (`_run_block`,
`_at_use`), a block's tensor-parallel units (an encoder layer's too)
keeping this rank's chunk. `LMModel.loss`
is the causal LM loss of the train step (`repro_torch.launch.train`); its
forward may recompute each layer in the backward (``remat``) and take the
flash backward of attention (``use_flash``).

Ported families: decoder-only stacks of ``attn`` / ``local`` blocks (the
dense family), of ``ssm`` blocks (Mamba-2) and of ``rglru`` and ``local``
blocks (RecurrentGemma's hybrid), and whisper's encoder-decoder: a
non-causal, RoPE-free encoder stack (``enc_blocks``, ``enc_norm``) over
given frame embeddings (``enc_embeds``, the stub frontend) with sinusoidal
positions, and decoder blocks with cross-attention over its output, whose
K/V the decode cache holds as ``xk``/``xv``. A recurrent block's decode
cache is its mixer's state (no sequence axis, float32 whatever the cache
dtype), passed through from prefill as the JAX package does. The MoE
family (phi3.5-moe, moonshot) puts `repro_torch.nn.moe`'s FFN in its
attention blocks; a forward sums the blocks' load-balance and z losses into
its aux, layer by layer in float32, as the JAX package's scan does, and
`loss` adds them. A VLM (internvl2) takes its stub frontend's patch
embeddings as ``prefix_embeds`` (B, P, d): `forward` and `prefill` put them,
cast to the compute dtype, in front of the token embeddings, and positions
run over all P + S; `loss` scores the trailing label positions only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.core import lm_compress, qat
from repro_torch.core.export import ServeArtifact
from repro_torch.distributed.sharding import (
    _axes_of,
    all_reduce,
    batch_reduce,
    copy_to_model,
    layer_gather,
    reduce_from_model,
    tp_matmul,
    vocab_lookup,
    vocab_parallel_nll,
)
from repro_torch.kernels.lut_matmul.ref import exact_matmul
from repro_torch.models.config import ArchConfig
from repro_torch.kernels.fake_quant.ops import MAX_CANDIDATES
from repro_torch.nn import transformer as T
from repro_torch.nn.layers import QuantConfig
from repro_torch.nn.spec import ParamSpec, normal_init, stack_specs
from repro_torch.nn.transformer import (
    apply_block,
    apply_block_chunk,
    apply_block_decode,
    block_cache_spec,
    make_block_spec,
)

NEG_INF = -1e30


def _layer(tree, r: int):
    """Layer ``r`` of a stacked tree (tensors, and `ServeArtifact` leaves
    whose fields carry the layer axis); 0-d leaves are shared by every
    layer."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    if isinstance(tree, ServeArtifact):
        return dataclasses.replace(tree, packed=tree.packed[r],
                                   codebook=tree.codebook[r],
                                   scale=tree.scale[r])
    if isinstance(tree, torch.Tensor) and tree.ndim:
        return tree[r]
    return tree


def _expert_entries(w: torch.Tensor, c, depth: Optional[int]):
    """K3 entries (weight, comp, candidates) of an expert unit: its leading
    (layer, expert) axes (or the tail's expert axis) flattened into one
    candidate axis, cut into entries of whole layers of at most
    `MAX_CANDIDATES` candidates each (contiguous slices)."""
    lead = 1 if depth is None else 2
    inner = tuple(w.shape[lead:])
    n_exp = w.shape[lead - 1]
    flat_w = w.reshape(-1, *inner)
    flat_c = None
    if c is not None:
        flat_c = {"mask": c["mask"].reshape(-1, *inner),
                  "codebook": c["codebook"].reshape(-1, c["codebook"]
                                                    .shape[-1]),
                  "codebook_k": c["codebook_k"].reshape(-1)}
        if "msr_bits" in c:
            mb = c["msr_bits"]
            flat_c["msr_bits"] = (mb.repeat_interleave(n_exp)
                                  if isinstance(mb, torch.Tensor) and mb.ndim
                                  else mb)
    rows = max(1, MAX_CANDIDATES // n_exp) * n_exp
    n = flat_w.shape[0]
    out = []
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        sl = None if flat_c is None else {
            k: v[r0:r1] if isinstance(v, torch.Tensor) and v.ndim else v
            for k, v in flat_c.items()}
        out.append((flat_w[r0:r1], sl, r1 - r0))
    return out


def _at_use(tree, *path: str):
    """``tree``, the params' subtree at ``path``, gathered where a meshed
    step holds it as slices (`repro_torch.distributed.sharding
    .layer_gather`); itself elsewhere."""
    hook = layer_gather()
    return tree if hook is None else hook(tree, *path)


def _run_block(fn, block_params, block_weff, key, *args, **kw):
    """``fn(params, *args, w_eff=block_weff, **kw)`` on one block. In a
    meshed step the block is gathered for this call and let go when it
    returns: every parameter but the matmul weights that ``block_weff``
    replaces, whose fake-quantized copies are gathered instead; a
    tensor-parallel sub-module keeps this rank's model chunk and runs split
    (``tp=``; an encoder layer's too). ``key``: `LMModel._layers`'s (top,
    name, layer) of the block, or ("enc_blocks", None, layer)."""
    hook = layer_gather()
    if hook is not None:
        top, name, r = key
        path = ("blocks" if top == "groups" else top,
                *(() if name is None else (name,)))
        stacked = r is not None
        if block_weff is not None:
            block_weff = hook(block_weff, *path, stacked=stacked)
        block_params = hook(block_params, *path, stacked=stacked,
                            skip=tuple(block_weff or ()))
        tp = hook.block_splits(*path)
        if tp is not None:
            kw = dict(kw, tp=tp)
    return fn(block_params, *args, w_eff=block_weff, **kw)


def _remat(layer, x):
    """``layer(x)`` under `torch.utils.checkpoint`. In a meshed step the
    recompute runs the whole layer, its collectives included, without
    stopping at the last tensor the backward needs, so that a layer's
    collectives run twice, always (the dry run's count)."""
    if layer_gather() is None:
        return checkpoint(layer, x, use_reentrant=False)
    with set_checkpoint_early_stop(False):
        return checkpoint(layer, x, use_reentrant=False)


def _readout_split(cfg: ArchConfig):
    """The vocabulary split of the read-out in a meshed step (the tied
    table's or the untied head's), or None."""
    hook = layer_gather()
    if hook is None:
        return None
    return hook.model_split("embed" if cfg.tie_embeddings else "lm_head")


def _global_amax_row(w, c, path, lead):
    """A meshed step's unit slice ``w`` (and its comp ``c``) viewed as
    (lead dims, rows, columns), with one more row holding each column's
    amax of ``|w * mask|`` over the whole tensor: the slice's amax,
    MAX-all-reduced over the mesh axes that shard the reduced dims (a max
    is exact in any order). K3's per-column scale of the result is then
    the gathered weight's, so its other rows are fake-quantized exactly as
    the gathered weight's would be. Returns (w, c, cut), ``cut`` taking
    K3's output back to ``w``'s shape; ``w`` itself and `_unchanged` where
    no axis shards the reduced dims."""
    s = layer_gather().sharding(*path)
    axes = [a for e in s.entries(w.ndim)[lead:-1] for a in _axes_of(e)]
    group = s.mesh.group(axes) if axes else None
    if group is None:
        return w, c, _unchanged
    shape = w.shape
    x = w.reshape(*shape[:lead], -1, shape[-1])
    mask = None if c is None else c["mask"].reshape(x.shape)
    wm = x.detach() if mask is None else x.detach() * mask.to(x.dtype)
    amax = all_reduce(wm.abs().amax(dim=-2, keepdim=True), "max", group)
    if c is None:
        c = qat.identity_comp(tuple(x.shape[lead:]), x.dtype,
                              device=x.device)
        if lead:
            c["mask"] = c["mask"].expand(x.shape)
        mask = c["mask"]
    c = dict(c, mask=torch.cat([mask, torch.ones_like(amax, dtype=mask.dtype)],
                               dim=-2))
    return (torch.cat([x, amax], dim=-2), c,
            lambda out: out[..., :-1, :].reshape(shape))


def _unchanged(y):
    return y




def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) int positions -> (B, S, d) float32 sinusoidal embeddings
    (whisper): sines of the first half, cosines of the second."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed(params, tokens, cfg: ArchConfig, pos_ids=None,
           prefix_embeds=None):
    """Token embeddings in the compute dtype (``embed_scale`` on the tokens
    only), with ``prefix_embeds`` (B, P, d) cast and put in front; the
    encoder-decoder family adds the sinusoid of ``pos_ids`` ((B, S);
    default 0..S-1 over every position). A meshed step whose table is split
    by vocabulary looks up its chunk's rows and sums over the model ranks
    (exact: one rank contributes each row)."""
    hook = layer_gather()
    split = None if hook is None else hook.model_split("embed")
    table = _at_use(params["embed"], "embed")["table"]
    if split is None:
        x = table[tokens.long()].to(cfg.cdtype)
    else:       # this rank's vocabulary chunk: masked rows, SUM over model
        x = reduce_from_model(vocab_lookup(table, tokens, split)
                              .to(cfg.cdtype), split)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype,
                             device=x.device)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.cdtype), x], dim=1)
    if cfg.encoder_decoder:
        if pos_ids is None:
            pos_ids = torch.arange(x.shape[1], dtype=torch.int32,
                                   device=x.device).expand(x.shape[:2])
        x = x + _sinusoid(pos_ids, cfg.d_model).to(x.dtype)
    return x


@dataclasses.dataclass
class LMModel:
    cfg: ArchConfig
    spec: dict

    # ------------------------------------------------------------ structure

    @property
    def n_pattern(self) -> int:
        return len(self.cfg.pattern)

    @property
    def n_rep(self) -> int:
        return self.cfg.n_layers // self.n_pattern

    @property
    def n_tail(self) -> int:
        return self.cfg.n_layers % self.n_pattern

    def _layers(self, params, comp, weff):
        """(block params, block comp, block w_eff, block type, cache key)
        of every layer in order: the stacked groups layer by layer, then
        the tail."""
        blocks_comp = None if comp is None else comp.get("blocks")
        tail_comp = None if comp is None else comp.get("tail")
        for r in range(self.n_rep):
            layer_params = _layer(params["blocks"], r)
            layer_comp = None if blocks_comp is None \
                else _layer(blocks_comp, r)
            for i, bt in enumerate(self.cfg.pattern):
                g = f"g{i}"
                yield (layer_params[g],
                       None if layer_comp is None else layer_comp.get(g),
                       None if weff is None else _layer(weff["blocks"][g], r),
                       bt, ("groups", g, r))
        for j in range(self.n_tail):
            t = f"t{j}"
            yield (params["tail"][t],
                   None if tail_comp is None else tail_comp.get(t),
                   None if weff is None else weff["tail"][t],
                   self.cfg.pattern[j], ("tail", t, None))

    # ------------------------------------------------------------- QAT

    def _fake_quant_units(self, params, comp, qcfg: QuantConfig):
        """Every compressible weight of the model fake-quantized at once,
        as {"blocks": {"g0": {"attn/wq": (L, ...)}}, "tail": {...},
        "enc_blocks": {"attn/wq": (L_enc, ...)}}, or None without QAT. The
        stacked units of all groups take one grouped K3 launch with the
        layer axis as K3's candidate axis, the encoder's stacked units with
        them when the two stacks are equally deep (else one launch of
        their own); the tail's units, unstacked, one more. A unit that
        serves from a packed artifact on the serve path is left out (K2
        runs it). An expert unit ((L, E, ...) stacked, (E, ...) in the
        tail) joins its launch with layers x experts as its candidates, so
        every expert keeps its own scales and codebook (`_expert_entries`).
        """
        if not qcfg.enabled:
            return None
        serve = qcfg.comp_mode == "serve"
        meshed = layer_gather() is not None
        out: Dict[str, Dict[str, dict]] = {"blocks": {}, "tail": {},
                                           "enc_blocks": {}}
        launches: Dict[Optional[int], list] = {}
        experts: list = []
        for top in ("blocks", "enc_blocks", "tail"):
            if top not in params:
                continue
            top_comp = None if comp is None else comp.get(top)
            groups = ({None: params[top]} if top == "enc_blocks"
                      else params[top])
            depth = {"blocks": self.n_rep, "tail": None,
                     "enc_blocks": self.cfg.n_enc_layers}[top]
            for g, block in groups.items():
                node = out[top] if g is None else out[top].setdefault(g, {})
                block_comp = top_comp if top_comp is None or g is None \
                    else top_comp.get(g)
                for unit in T.block_matmuls(block):
                    c = None if block_comp is None else block_comp.get(unit)
                    if serve and c is not None and "serve" in c:
                        continue
                    sub, key = unit.split("/")
                    w = block[sub][key]
                    c = None if c is None else \
                        {k: v for k, v in c.items() if k != "serve"}
                    expert = lm_compress.is_expert_unit(unit)
                    cut = _unchanged
                    if meshed:     # this rank's slices, the global scales
                        path = (top,) if g is None else (top, g)
                        w, c, cut = _global_amax_row(
                            w, c, (*path, unit),
                            (depth is not None) + expert)
                    todo = launches.setdefault(depth, [])
                    if expert:
                        pieces: list = []
                        todo.extend((*e, pieces.append)
                                    for e in _expert_entries(w, c, depth))
                        experts.append((node, unit, w.shape, pieces, cut))
                    else:
                        todo.append((w, c, depth,
                                     lambda y, node=node, unit=unit, cut=cut:
                                     node.__setitem__(unit, cut(y))))
        for entries in launches.values():
            cands = [e[2] for e in entries]
            outs = qat.fake_quant_weights(
                [e[0] for e in entries], [e[1] for e in entries],
                cands[0] if len(set(cands)) == 1 else cands)
            for (*_, put), w in zip(entries, outs):
                put(w)
        for node, unit, shape, pieces, cut in experts:
            node[unit] = cut((pieces[0] if len(pieces) == 1
                              else torch.cat(pieces)).reshape(shape))
        return out

    # ------------------------------------------------------------- encoder

    def _encode(self, params, enc_embeds: torch.Tensor, *, qcfg, comp, weff,
                remat: bool, q_block: int, kv_block: int) -> torch.Tensor:
        """The encoder stack over frame embeddings (B, S_enc, d): sinusoidal
        positions, non-causal RoPE-free ``attn`` blocks, ``enc_norm``."""
        cfg = self.cfg
        x = enc_embeds.to(cfg.cdtype)
        b, s, _ = x.shape
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        x = x + _sinusoid(pos, cfg.d_model).to(x.dtype)
        enc_comp = None if comp is None else comp.get("enc_blocks")
        for r in range(cfg.n_enc_layers):
            def layer(x, r=r):
                return _run_block(
                    apply_block, _layer(params["enc_blocks"], r),
                    None if weff is None else _layer(weff["enc_blocks"], r),
                    ("enc_blocks", None, r), x, cfg, "attn", positions=pos,
                    qcfg=qcfg,
                    comp=None if enc_comp is None else _layer(enc_comp, r),
                    q_block=q_block, kv_block=kv_block, encoder=True)[0]

            x = _remat(layer, x) if remat else layer(x)
        return T.apply_norm(_at_use(params["enc_norm"], "enc_norm"), x, cfg,
                            qcfg.batch_invariant)

    def _enc_out(self, params, enc_embeds, **kw) -> Optional[torch.Tensor]:
        """The encoder output of an encoder-decoder model (None for the
        others, whatever ``enc_embeds``)."""
        if not self.cfg.encoder_decoder:
            return None
        if enc_embeds is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder model: "
                             f"its forward needs enc_embeds (B, S_enc, "
                             f"{self.cfg.d_model})")
        return self._encode(params, enc_embeds, **kw)

    # ------------------------------------------------------------- forward

    def forward(self, params, tokens: torch.Tensor, *,
                prefix_embeds: Optional[torch.Tensor] = None,
                enc_embeds: Optional[torch.Tensor] = None,
                qcfg: QuantConfig = QuantConfig.off(), comp=None,
                remat: bool = False, q_block: int = 512,
                kv_block: int = 512, use_flash: bool = False,
                remat_policy: Optional[str] = None,
                exact_readout: bool = False
                ) -> Tuple[torch.Tensor, dict]:
        """Returns (logits (B, P + S, padded_vocab) float32, aux), P the
        length of ``prefix_embeds`` (B, P, d) (0 without).
        ``exact_readout``: the read-out correctly rounded (as under
        ``qcfg.batch_invariant``): `loss`'s under QAT.

        ``remat``: each layer runs under `torch.utils.checkpoint`
        (non-reentrant), so the backward recomputes its activations instead
        of keeping them; the gradients are those without it, bit for bit.
        The one grouped K3 launch stays outside the checkpointed layers,
        and its fake-quantized weights are kept for the backward: that is
        the JAX package's ``remat_policy="save_qat"``, which is therefore
        what the port does under either policy (the argument is accepted
        and changes nothing); in a meshed step those are the rank's slices,
        and each layer gathers its block inside the checkpoint.
        ``use_flash``: attention's flash backward (`repro_torch.nn.flash`).
        ``enc_embeds`` (B, S_enc, d): the encoder-decoder family's frame
        embeddings (required there)."""
        cfg = self.cfg
        x = _embed(params, tokens, cfg, prefix_embeds=prefix_embeds)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        aux = {"lb_loss": torch.zeros((), device=x.device),
               "z_loss": torch.zeros((), device=x.device)}
        weff = self._fake_quant_units(params, comp, qcfg)
        enc_out = self._enc_out(params, enc_embeds, qcfg=qcfg, comp=comp,
                                weff=weff, remat=remat, q_block=q_block,
                                kv_block=kv_block)
        for block_params, block_comp, block_weff, bt, key in self._layers(
                params, comp, weff):
            def layer(x, block_params=block_params, block_comp=block_comp,
                      block_weff=block_weff, bt=bt, key=key):
                # a meshed step gathers the block here, inside the
                # checkpointed layer: remat's recompute gathers it again
                return _run_block(apply_block, block_params, block_weff, key,
                                  x, cfg, bt, positions=positions, qcfg=qcfg,
                                  comp=block_comp, enc_out=enc_out,
                                  q_block=q_block, kv_block=kv_block,
                                  use_flash=use_flash)

            if remat:
                x, a = _remat(layer, x)
            else:
                x, a = layer(x)
            aux = {k: aux[k] + a[k] for k in aux}
        x = self._final_norm(params, x, qcfg)
        return self._unembed(params, x, exact_readout
                             or qcfg.batch_invariant), aux

    # ----------------------------------------------------------------- loss

    def loss(self, params, batch: Dict[str, torch.Tensor], **fwd_kwargs):
        """Causal LM loss: (total, {"ce", "lb_loss", "z_loss"}). ``batch``
        holds ``tokens`` and ``labels`` (B, S), optionally ``loss_mask``,
        (a VLM) ``prefix_embeds`` and (the encoder-decoder family)
        ``enc_embeds``; the log-softmax is taken over the trailing label
        positions (a prefix's are not scored), and ``total = ce + 0.01 *
        lb_loss + 1e-3 * z_loss`` (both zero for the dense family).
        ``fwd_kwargs`` go to `forward`. Inside a meshed step whose batch
        is split over ranks (`repro_torch.distributed.sharding
        .batch_reduction`) ``batch`` is this rank's rows and the loss is
        the global batch's: the masked sum and the count are summed over
        the ranks in float64; where the read-out is split by vocabulary the
        log-softmax is too. Split or not, the log-softmax sums its
        exponentials in float64 (`vocab_parallel_nll`), so both give the
        same bits."""
        # under QAT the read-out is correctly rounded, as every product of
        # the QAT forward: a meshed step whose vocabulary splits then
        # computes this step's logits and gradients, bit for bit
        qcfg = fwd_kwargs.get("qcfg", QuantConfig.off())
        logits, aux = self.forward(params, batch["tokens"],
                                   prefix_embeds=batch.get("prefix_embeds"),
                                   enc_embeds=batch.get("enc_embeds"),
                                   exact_readout=qcfg.enabled, **fwd_kwargs)
        labels = batch["labels"].long()
        logits_tok = logits[:, logits.shape[1] - labels.shape[1]:]
        # this rank's vocabulary chunk of the logits where the read-out is
        # split, else the whole (the same function: the same bits)
        nll = vocab_parallel_nll(logits_tok, labels,
                                 _readout_split(self.cfg))
        mask = batch.get("loss_mask")
        red = batch_reduce()
        if red is not None:
            # a meshed step's rows: sums and counts over the global batch
            # (a mean of per-rank means would weigh ranks, not tokens)
            mask = torch.ones_like(nll) if mask is None \
                else mask.to(nll.dtype)
            num = red.sum((nll * mask).sum(dtype=torch.float64))
            den = red.sum(mask.sum(dtype=torch.float64))
            loss = (num / torch.clamp(den, min=1.0)).float()
        elif mask is not None:
            mask = mask.to(nll.dtype)
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        else:
            loss = nll.mean()
        total = loss + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
        return total, {"ce": loss, "lb_loss": aux["lb_loss"],
                       "z_loss": aux["z_loss"]}

    def _final_norm(self, params, x, qcfg):
        return T.apply_norm(_at_use(params["final_norm"], "final_norm"), x,
                            self.cfg, qcfg.batch_invariant)

    def _unembed(self, params, x, exact: bool = False):
        """Logits in float32 with the vocab padding masked to -1e30 (the
        tied read-out is a plain product in the activations' dtype, or with
        ``exact`` a correctly rounded one: `QuantConfig.batch_invariant`,
        and `loss` under QAT).
        In a meshed step whose read-out is split by vocabulary: this rank's
        chunk of the vocabulary (column-parallel)."""
        cfg = self.cfg
        w = (_at_use(params["embed"], "embed")["table"].T
             if cfg.tie_embeddings
             else _at_use(params["lm_head"], "lm_head")["w"]).to(x.dtype)
        split = _readout_split(cfg)
        start = 0
        if split is not None:
            logits = tp_matmul(copy_to_model(x, split, exact), w, split,
                               "column", exact)
            start = split.chunk(w.shape[-1] * split.size)[1]
        else:
            logits = exact_matmul(x, w) if exact else torch.matmul(x, w)
        pad_mask = torch.arange(start, start + w.shape[-1],
                                device=x.device) >= cfg.vocab
        return torch.where(pad_mask, torch.full((), NEG_INF, device=x.device),
                           logits.float())

    # --------------------------------------------------------------- caches

    def cache_spec(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   cross_len: int = 0) -> dict:
        """Shape-and-dtype placeholders (meta tensors) of a decode cache:
        {"groups": {"g<i>": {"k", "v"} (L, B, Smax, Hkv, D)}, "tail":
        {...}, "pos": (B,) int32, the per-sequence position}. A recurrent
        block's leaves are its mixer's state ({"state", "conv"} or {"h",
        "conv"}: batch, then no sequence axis), float32 whatever
        ``dtype``. ``cross_len``: each attention block also holds the
        cross-attention K/V ``xk``/``xv`` (B, cross_len, Hkv, D)."""
        cfg = self.cfg
        spec: Dict[str, Any] = {"groups": {}, "tail": {}}
        for i, bt in enumerate(cfg.pattern):
            one = block_cache_spec(cfg, bt, batch, max_len, dtype,
                                   cross_len=cross_len)
            spec["groups"][f"g{i}"] = {
                k: torch.empty((self.n_rep, *s.shape), dtype=s.dtype,
                               device="meta") for k, s in one.items()}
        for j in range(self.n_tail):
            spec["tail"][f"t{j}"] = block_cache_spec(
                cfg, cfg.pattern[j], batch, max_len, dtype,
                cross_len=cross_len)
        spec["pos"] = torch.empty((batch,), dtype=torch.int32, device="meta")
        return spec

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   cross_len: int = 0, *, device) -> dict:
        from repro_torch._device import tree_map

        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=device),
                        self.cache_spec(batch, max_len, dtype, cross_len))

    # --------------------------------------------------------------- decode

    def decode_step(self, params, cache: dict, tokens: torch.Tensor, *,
                    qcfg: QuantConfig = QuantConfig.off(), comp=None,
                    active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, dict]:
        """One token for every sequence of the batch: tokens (B, 1).
        Returns (logits (B, 1, padded_vocab), new cache); ``cache["pos"]``
        is per sequence (B,). Rows where ``active`` (B,) is False keep
        their cache and position (their logits are to be ignored). The
        encoder-decoder family's cross-attention reads the cache's
        ``xk``/``xv``."""
        cfg = self.cfg
        pos = cache["pos"]
        pos_ids = None
        if cfg.encoder_decoder:
            pos_ids = pos.to(torch.int32)
            pos_ids = pos_ids[:, None] if pos_ids.ndim \
                else pos_ids.expand(tokens.shape)
        x = _embed(params, tokens, cfg, pos_ids)
        weff = self._fake_quant_units(params, comp, qcfg)
        new_cache: Dict[str, Any] = {"groups": {}, "tail": {},
                                     "pos": pos + 1}
        group_layers: Dict[str, list] = {g: [] for g in cache["groups"]}
        for block_params, block_comp, block_weff, bt, (top, key, r) in \
                self._layers(params, comp, weff):
            layer_cache = (_layer(cache["groups"][key], r) if top == "groups"
                           else cache["tail"][key])
            x, c_new = _run_block(apply_block_decode, block_params,
                                  block_weff, (top, key, r), x, layer_cache,
                                  pos, cfg, bt, qcfg=qcfg, comp=block_comp)
            if top == "groups":
                group_layers[key].append(c_new)
            else:
                new_cache["tail"][key] = c_new
        for g, caches in group_layers.items():
            new_cache["groups"][g] = {k: torch.stack([c[k] for c in caches])
                                      for k in caches[0]}
        if active is not None:
            new_cache = self._merge_active(cache, new_cache, active)
        x = self._final_norm(params, x, qcfg)
        return self._unembed(params, x, qcfg.batch_invariant), new_cache

    @staticmethod
    def _merge_active(old_cache: dict, new_cache: dict, active) -> dict:
        """Keep inactive rows' cache untouched. ``groups`` leaves carry the
        layer axis first (batch is axis 1); ``tail`` and ``pos`` leaves
        have batch leading; a leaf's other axes (a sequence axis or none)
        do not matter."""
        act = active.to(torch.bool)

        def merge(axis, new, old):
            shape = [1] * new.ndim
            shape[axis] = act.shape[0]
            return torch.where(act.reshape(shape), new, old)

        return {
            "groups": {g: {k: merge(1, v, old_cache["groups"][g][k])
                           for k, v in c.items()}
                       for g, c in new_cache["groups"].items()},
            "tail": {t: {k: merge(0, v, old_cache["tail"][t][k])
                         for k, v in c.items()}
                     for t, c in new_cache["tail"].items()},
            "pos": torch.where(act, new_cache["pos"], old_cache["pos"]),
        }

    # --------------------------------------------------------------- prefill

    def prefill(self, params, tokens: torch.Tensor, max_len: int, *,
                prefix_embeds: Optional[torch.Tensor] = None,
                enc_embeds: Optional[torch.Tensor] = None,
                qcfg: QuantConfig = QuantConfig.off(), comp=None,
                cache_dtype=torch.bfloat16, q_block: int = 512,
                kv_block: int = 512) -> Tuple[torch.Tensor, dict]:
        """Forward over the prompt (B, S), after ``prefix_embeds`` (B, P,
        d) where given, capturing each layer's K/V into a decode cache
        (and, with ``enc_embeds``, the cross-attention K/V over the encoder
        output as ``xk``/``xv`` in ``cache_dtype``). Returns (logits (B,
        P + S, V), cache ready at pos = P + S)."""
        cfg = self.cfg
        x = _embed(params, tokens, cfg, prefix_embeds=prefix_embeds)
        b, s = x.shape[:2]
        dev = x.device
        positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
        cache: Dict[str, Any] = {
            "groups": {}, "tail": {},
            "pos": torch.full((b,), s, dtype=torch.int32, device=dev)}
        group_states: Dict[str, list] = {f"g{i}": []
                                         for i in range(self.n_pattern)}
        weff = self._fake_quant_units(params, comp, qcfg)
        enc_out = self._enc_out(params, enc_embeds, qcfg=qcfg, comp=comp,
                                weff=weff, remat=False, q_block=q_block,
                                kv_block=kv_block)
        for block_params, block_comp, block_weff, bt, (top, key, r) in \
                self._layers(params, comp, weff):
            (x, _), st = _run_block(apply_block, block_params, block_weff,
                                    (top, key, r), x, cfg, bt,
                                    positions=positions, qcfg=qcfg,
                                    comp=block_comp, enc_out=enc_out,
                                    q_block=q_block, kv_block=kv_block,
                                    return_state=True)
            st = self._state_to_cache(st, bt, max_len, cache_dtype)
            if top == "groups":
                group_states[key].append(st)
            else:
                cache["tail"][key] = st
        for g, sts in group_states.items():
            if sts:
                cache["groups"][g] = {k: torch.stack([st[k] for st in sts])
                                      for k in sts[0]}
        x = self._final_norm(params, x, qcfg)
        return self._unembed(params, x, qcfg.batch_invariant), cache

    # ------------------------------------------------------- chunked prefill

    def prefill_chunk(self, params, cache: dict, tokens: torch.Tensor, *,
                      start: torch.Tensor,
                      qcfg: QuantConfig = QuantConfig.off(), comp=None,
                      q_block: int = 8, kv_block: int = 8
                      ) -> Tuple[torch.Tensor, dict]:
        """One prefill chunk per row against an existing decode cache:
        tokens (B, C), row r at positions ``start[r] .. start[r] + C - 1``.
        Returns (logits (B, C, V), the cache with ``pos = start + C``); the
        last chunk's final position seeds the first sampled token.
        Encoder-decoder models have no chunk path (`ValueError`, as in the
        JAX package)."""
        cfg = self.cfg
        if cfg.encoder_decoder:
            raise ValueError("chunked prefill does not support "
                             "encoder-decoder models; use the oneshot path")
        b, c = tokens.shape
        start = start.to(torch.int32)
        positions = start[:, None] + torch.arange(
            c, dtype=torch.int32, device=tokens.device)[None, :]
        x = _embed(params, tokens, cfg)
        weff = self._fake_quant_units(params, comp, qcfg)
        new_cache: Dict[str, Any] = {"groups": {}, "tail": {},
                                     "pos": start + c}
        group_layers: Dict[str, list] = {g: [] for g in cache["groups"]}
        for block_params, block_comp, block_weff, bt, (top, key, r) in \
                self._layers(params, comp, weff):
            layer_cache = (_layer(cache["groups"][key], r) if top == "groups"
                           else cache["tail"][key])
            x, c_new = _run_block(apply_block_chunk, block_params,
                                  block_weff, (top, key, r), x, layer_cache,
                                  positions, cfg, bt, qcfg=qcfg,
                                  comp=block_comp, q_block=q_block,
                                  kv_block=kv_block)
            if top == "groups":
                group_layers[key].append(c_new)
            else:
                new_cache["tail"][key] = c_new
        for g, caches in group_layers.items():
            new_cache["groups"][g] = {k: torch.stack([ch[k] for ch in caches])
                                      for k in caches[0]}
        x = self._final_norm(params, x, qcfg)
        return self._unembed(params, x, qcfg.batch_invariant), new_cache

    # ---------------------------------------------------- cache row shuffles

    @staticmethod
    def gather_cache_rows(cache: dict, rows: torch.Tensor) -> dict:
        """Rows (int (Bc,)) of a decode cache as a smaller cache. ``groups``
        leaves carry the layer axis first (batch is axis 1); ``tail`` and
        ``pos`` leaves have batch leading, whatever axes follow."""
        rows = rows.long()
        return {
            "groups": {g: {k: v.index_select(1, rows) for k, v in c.items()}
                       for g, c in cache["groups"].items()},
            "tail": {t: {k: v.index_select(0, rows) for k, v in c.items()}
                     for t, c in cache["tail"].items()},
            "pos": cache["pos"].index_select(0, rows),
        }

    @staticmethod
    def scatter_cache_rows(cache: dict, rows: torch.Tensor, row_cache: dict,
                           active: torch.Tensor) -> dict:
        """``row_cache`` (batch Bc) written back into ``cache`` at ``rows``.
        ``active`` (Bc,) bool masks padding rows; active entries of ``rows``
        must be distinct. Inactive and unlisted rows keep their state. A
        written leaf keeps ``cache``'s dtype (a recurrent row's conv
        history comes out of a chunk in the activations' dtype; the
        group cache holds it in float32, as the JAX package's ``where``
        promotes it)."""
        b = cache["pos"].shape[0]
        sel = (torch.arange(b, device=rows.device)[:, None]
               == rows.long()[None, :]) & active.to(torch.bool)[None, :]
        hit = sel.any(dim=1)                                 # (B,)
        src = sel.to(torch.int8).argmax(dim=1)               # (B,) source row

        def put(axis, old, new):
            shape = [1] * old.ndim
            shape[axis] = b
            return torch.where(hit.reshape(shape),
                               new.index_select(axis, src).to(old.dtype),
                               old)

        return {
            "groups": {g: {k: put(1, v, row_cache["groups"][g][k])
                           for k, v in c.items()}
                       for g, c in cache["groups"].items()},
            "tail": {t: {k: put(0, v, row_cache["tail"][t][k])
                         for k, v in c.items()}
                     for t, c in cache["tail"].items()},
            "pos": put(0, cache["pos"], row_cache["pos"]),
        }

    def _state_to_cache(self, st, bt, max_len, dtype):
        """A block's prefill K/V (B, S, Hkv, D) as its decode cache: the
        last ``min(S, cache_len)`` positions at their slots ``pos mod
        cache_len``, zeros elsewhere; cross-attention K/V (``xk``/``xv``)
        whole, in ``dtype``. A recurrent mixer's state is already in cache
        layout and passes through unchanged (its dtypes too)."""
        if bt in T.RECURRENT:
            return st
        dims = self.cfg.attn_dims(bt == "local")
        cache_len = min(max_len, dims.window) if dims.window else max_len
        k, v = st["k"], st["v"]
        b, s = k.shape[:2]
        take = min(s, cache_len)
        slots = torch.remainder(torch.arange(s - take, s, device=k.device),
                                cache_len)
        kc = torch.zeros((b, cache_len, *k.shape[2:]), dtype=dtype,
                         device=k.device)
        vc = torch.zeros((b, cache_len, *v.shape[2:]), dtype=dtype,
                         device=v.device)
        kc[:, slots] = k[:, s - take:].to(dtype)
        vc[:, slots] = v[:, s - take:].to(dtype)
        out = {"k": kc, "v": vc}
        if "xk" in st:
            out["xk"], out["xv"] = st["xk"].to(dtype), st["xv"].to(dtype)
        return out


def build_lm(cfg: ArchConfig) -> LMModel:
    """The spec tree of an LM of the dense (a VLM's backbone too: its
    prefix is an input, no parameter), MoE, SSM (Mamba-2), hybrid
    (RecurrentGemma) or encoder-decoder (whisper: ``enc_blocks`` stacked
    over ``n_enc_layers``, ``enc_norm``, decoder blocks with
    cross-attention) family."""
    spec: Dict[str, Any] = {
        "embed": {"table": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                     cfg.pdtype, ("vocab", "embed"),
                                     normal_init(0.02))},
        "final_norm": T.make_norm_spec(cfg),
    }
    n_pat = len(cfg.pattern)
    n_rep = cfg.n_layers // n_pat
    n_tail = cfg.n_layers % n_pat
    if n_rep > 0:
        group = {f"g{i}": make_block_spec(cfg, bt,
                                          cross_attn=cfg.encoder_decoder)
                 for i, bt in enumerate(cfg.pattern)}
        spec["blocks"] = stack_specs(group, n_rep, "layers")
    if n_tail:
        spec["tail"] = {f"t{j}": make_block_spec(
            cfg, cfg.pattern[j], cross_attn=cfg.encoder_decoder)
            for j in range(n_tail)}
    if cfg.encoder_decoder:
        spec["enc_blocks"] = stack_specs(
            make_block_spec(cfg, "attn", cross_attn=False),
            cfg.n_enc_layers, "layers")
        spec["enc_norm"] = T.make_norm_spec(cfg)
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"w": ParamSpec((cfg.d_model, cfg.padded_vocab),
                                          cfg.pdtype, ("embed", "vocab"),
                                          normal_init(0.02))}
    return LMModel(cfg, spec)
