"""CNN training, evaluation and profiling runner of the compression
pipeline (port of `repro.core.runner`).

Bundles a `CNNModel`, a dataset and one device. The compression state
``comp`` ({layer_name: CompState}) is a plain argument of every method.
Ported: parameter init, the QAT train step (cross-entropy, backward,
global-norm clip and AdamW, every compressible weight fake-quantized through
K3), training loops, accuracy, the schedule's batched candidate sweep
(`train_batched`, `accuracy_batched`, `accuracy_comps`, `accuracy_gather`:
n candidates in one forward a batch, the JAX package's ``vmap`` written out
as a candidate axis), the profiling taps, the per-layer trace statistics
(one transition-statistics kernel launch per layer) and the per-layer
energy models.

Two optional 1-D meshes (`repro_torch.distributed.sharding`), as in the JAX
package: ``profile_mesh`` splits each layer's tile batch over ("tiles",)
(`profiler.sharded_layer_stats`), and ``sweep_mesh`` splits the batched
sweep's candidate axis over ("candidates",). `train_batched`,
`accuracy_batched` and `accuracy_comps` pad the candidates to a multiple of
the mesh size (`qat.pad_leading`), run each shard's slice on its device
(one grouped K3 launch a shard and forward), gather the results on the
runner's device and drop the padded slots. A candidate's arithmetic does
not depend on how many candidates share a call, so the sharded sweep equals
the unsharded one bit for bit. `accuracy_gather` stays unsharded, as in the
JAX package.

The dataset is any object with ``batch(step, batch_size, split, *,
device) -> (images, labels)``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import (
    DEFAULT_DEVICE,
    resolve_device,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.core import qat
from repro_torch.core.energy_lut import blended_lut
from repro_torch.core.layer_energy import LayerEnergyModel, weight_value_counts
from repro_torch.core.profiler import profile_layer
from repro_torch.core.stats import LayerStats, conv_weight_matrix, im2col
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.distributed.sharding import (
    SWEEP_AXIS,
    TILE_AXIS,
    LocalMesh,
    check_mesh,
    concat_leading,
    device_scope,
    split_leading,
    to_device,
)
from repro_torch.nn.cnn import CNNModel
from repro_torch.nn.layers import QuantConfig
from repro_torch.nn.spec import init_params
from repro_torch.optim.optimizers import adamw, apply_updates


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of (B, classes) logits, a 0-d tensor; of (B, n,
    classes) logits (n candidates on one batch) one mean a candidate, (n,).
    The mean is summed in float64 and rounded once, so a candidate's loss
    does not depend on how many candidates share the call."""
    logp = F.log_softmax(logits.float(), dim=-1)
    idx = labels.long().reshape((-1,) + (1,) * (logits.ndim - 1))
    nll = -torch.gather(logp, -1, idx.expand(*logits.shape[:-1], 1))[..., 0]
    return nll.mean(dim=0, dtype=torch.float64).float()


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Candidates ``idx`` of a stacked leaf; a leaf shared by every
    candidate (stride 0) stays shared."""
    if x.stride(0) == 0:
        return x[:1].expand((len(idx),) + tuple(x.shape[1:]))
    return x.index_select(0, idx)


def layer_seed(name: str) -> int:
    """Tile-sampling seed of a layer: crc32 of its name (the JAX package's
    key; `str` hashes are salted per interpreter run)."""
    return zlib.crc32(name.encode()) % (2 ** 31)


@dataclasses.dataclass
class CnnRunner:
    model: CNNModel
    dataset: SyntheticImages
    batch_size: int = 128
    lr: float = 1e-3
    qcfg: QuantConfig = QuantConfig.on()
    seed: int = 0
    device: Any = DEFAULT_DEVICE
    profile_mesh: Optional[LocalMesh] = None   # sharding.tile_mesh
    sweep_mesh: Optional[LocalMesh] = None     # sharding.sweep_mesh

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.profile_mesh is not None:
            check_mesh(self.profile_mesh, TILE_AXIS)
        if self.sweep_mesh is not None:
            check_mesh(self.sweep_mesh, SWEEP_AXIS)
        self.optimizer = adamw(self.lr)
        self._stats_cache: Optional[Dict[str, LayerStats]] = None

    # ------------------------------------------------------------------ setup

    def init(self):
        """(params, state, opt_state, comp) of a fresh model on the device."""
        params = init_params(self.seed, self.model.spec, self.device)
        state = init_params(self.seed, self.model.state_spec, self.device)
        # AdamW in the JAX optimizer's state layout, so a plan written here
        # resumes there
        opt_state = self.optimizer.init(params)
        return params, state, opt_state, self.identity_comp(params)

    def identity_comp(self, params) -> Dict[str, qat.CompState]:
        comp = {}
        for cl in self.model.comp_layers:
            w = self.model.get_weight(params, cl.name)
            comp[cl.name] = qat.identity_comp(tuple(w.shape), w.dtype,
                                              device=w.device)
        return comp

    # ------------------------------------------------------------------ train

    @staticmethod
    def _n_candidates(comps) -> int:
        """The candidate count of a stacked comp tree (its leading axis)."""
        return int(tree_leaves(comps)[0].shape[0])

    def loss_and_grads(self, params, state, comp, batch, cands=None):
        """(loss, grads, new_state) of one training batch: train-mode
        forward, mean cross-entropy, backward. ``grads`` has the structure
        of ``params``; ``loss`` stays on the device. ``cands=n``: n stacked
        candidates (see `CNNModel`), ``loss`` (n,), each candidate's
        gradient that of its own loss."""
        x, y = batch
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        p = tree_unflatten(params, iter(leaves))
        logits, new_state = self.model.apply(p, state, x, train=True,
                                             qcfg=self.qcfg, comp=comp,
                                             cands=cands)
        loss = cross_entropy(logits, y)
        grads = torch.autograd.grad(loss.sum(), leaves)
        return loss.detach(), tree_unflatten(params, iter(grads)), new_state

    def train_step(self, params, state, opt_state, comp, batch, cands=None):
        """One QAT step: `loss_and_grads`, then AdamW (global-norm clip
        inside; one a candidate under ``cands``). Returns (params, state,
        opt_state, loss)."""
        loss, grads, new_state = self.loss_and_grads(params, state, comp,
                                                     batch, cands)
        updates, opt_state = self.optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), new_state, opt_state, loss

    def train(self, params, state, opt_state, comp, n_steps: int,
              start_step: int = 0, log_every: int = 0):
        """``n_steps`` QAT steps on training batches ``start_step...``.
        Returns (params, state, opt_state, last loss as a float, NaN for no
        step); the loss is read back to the host once, at the end."""
        loss = torch.tensor(float("nan"))
        for i in range(n_steps):
            batch = self.dataset.batch(start_step + i, self.batch_size,
                                       "train", device=self.device)
            params, state, opt_state, loss = self.train_step(
                params, state, opt_state, comp, batch)
            if log_every and (i + 1) % log_every == 0:
                print(f"  step {start_step + i + 1}: loss={float(loss):.4f}")
        return params, state, opt_state, float(loss)

    def train_batched(self, params, state, opt_state, comps, n_steps: int,
                      start_step: int = 0):
        """Train n stacked candidates in lockstep, one step of all of them a
        batch. ``params``, ``state``, ``opt_state`` and ``comps`` carry a
        leading candidate axis (`qat.stack_pytrees` /
        `qat.broadcast_pytree`); every candidate sees the batch stream
        `train` would feed it, so candidate j's trajectory is the serial
        trial fine-tune of candidate j.
        Returns (params, state, opt_state, per-candidate final loss as a
        numpy array, NaN for no step), read back once. Under
        ``sweep_mesh`` each shard's candidates take their steps on the
        shard's device."""
        n = self._n_candidates(comps)
        cands, shards = self._shards(self.sweep_mesh, params, state,
                                     opt_state, comps)
        losses = [torch.full((cands,), float("nan"))] * len(shards)
        for i in range(n_steps):
            batch = self.dataset.batch(start_step + i, self.batch_size,
                                       "train", device=self.device)
            for j, (dev, (p, s, o, c)) in enumerate(shards):
                with device_scope(dev):
                    p, s, o, losses[j] = self.train_step(
                        p, s, o, c, to_device(batch, dev), cands=cands)
                shards[j] = (dev, (p, s, o, c))
        params, state, opt_state = (
            tree_map(lambda x: x[:n], concat_leading(
                [sh[k] for _, sh in shards], self.device))
            for k in range(3))
        loss = torch.cat([x.cpu() for x in losses])[:n]
        return params, state, opt_state, loss.numpy()

    def _shards(self, mesh, *trees):
        """(candidates a shard, [(device, trees of the shard)]): the stacked
        trees padded to a multiple of ``mesh``'s size and split into one
        slice a shard, each on its shard's device; without a mesh one
        shard, all of them on the runner's device."""
        devices = (self.device,) if mesh is None else mesh.devices
        m = len(devices)
        n_pad = -(-self._n_candidates(trees[-1]) // m) * m
        parts = [split_leading(qat.pad_leading(t, n_pad), m) for t in trees]
        return n_pad // m, [(dev, tuple(to_device(p[i], dev) for p in parts))
                            for i, dev in enumerate(devices)]

    def _correct(self, params, state, comp, x, y, cands=None):
        """Correct predictions on one batch, on the device: a 0-d count, or
        (n,) under ``cands``."""
        logits, _ = self.model.apply(params, state, x, train=False,
                                     qcfg=self.qcfg, comp=comp, cands=cands)
        hit = logits.argmax(-1) == (y if cands is None else y[:, None])
        return hit.sum(0)

    def accuracy(self, params, state, comp, n_batches: int = 8,
                 split: str = "val") -> float:
        correct = 0
        with torch.no_grad():
            for i in range(n_batches):
                x, y = self.dataset.batch(i, self.batch_size, split,
                                          device=self.device)
                correct += int(self._correct(params, state, comp, x, y))
        return correct / (n_batches * self.batch_size)

    def accuracy_batched(self, params, state, comps, n_batches: int = 8,
                         split: str = "val") -> np.ndarray:
        """Per-candidate accuracy vector of stacked params/state/comps: one
        forward of all candidates a batch (one a shard under
        ``sweep_mesh``), the counts read back once."""
        return self._accuracy(self.sweep_mesh, params, state, comps,
                              n_batches, split)

    def _accuracy(self, mesh, params, state, comps, n_batches, split):
        n = self._n_candidates(comps)
        cands, shards = self._shards(mesh, params, state, comps)
        correct = [torch.zeros((cands,), dtype=torch.int64, device=dev)
                   for dev, _ in shards]
        with torch.no_grad():
            for i in range(n_batches):
                x, y = self.dataset.batch(i, self.batch_size, split,
                                          device=self.device)
                for j, (dev, (p, s, c)) in enumerate(shards):
                    with device_scope(dev):
                        correct[j] += self._correct(p, s, c, x.to(dev),
                                                    y.to(dev), cands)
        counts = torch.cat([c.cpu() for c in correct])[:n]
        return (counts.numpy().astype(np.float64)
                / (n_batches * self.batch_size))

    def accuracy_comps(self, params, state, comps, n_batches: int = 8,
                       split: str = "val") -> np.ndarray:
        """Accuracy of n stacked comp variants sharing one params/state (not
        copied: stride-0 views, which K3 reads once; they stay views on each
        shard under ``sweep_mesh``)."""
        n = self._n_candidates(comps)
        return self.accuracy_batched(qat.broadcast_pytree(params, n),
                                     qat.broadcast_pytree(state, n), comps,
                                     n_batches, split)

    def accuracy_gather(self, params_s, state_s, comps_e, idx,
                        n_batches: int = 8, split: str = "val") -> np.ndarray:
        """Accuracy of E comp variants, variant e with the params/state of
        stacked candidate ``idx[e]``: one forward of all E variants a batch
        (the lockstep elimination's fused requests, each against its own
        candidate's fine-tuned weights)."""
        idx = torch.as_tensor(idx, dtype=torch.long, device=self.device)
        return self._accuracy(None, tree_map(lambda x: _take(x, idx),
                                             params_s),
                              tree_map(lambda x: _take(x, idx), state_s),
                              comps_e, n_batches, split)

    # ---------------------------------------------------------------- profile

    def capture_taps(self, params, state, comp, n_batches: int = 1):
        """Merged taps {layer: {a_int, w_int}} over a few val batches."""
        taps_all: Dict[str, dict] = {}
        with torch.no_grad():
            for i in range(n_batches):
                x, _ = self.dataset.batch(i, self.batch_size, "val",
                                          device=self.device)
                _, _, taps = self.model.apply(params, state, x, train=False,
                                              qcfg=self.qcfg, comp=comp,
                                              capture_taps=True)
                for name, t in taps.items():
                    if name in taps_all:
                        taps_all[name]["a_int"] = torch.cat(
                            [taps_all[name]["a_int"], t["a_int"]], dim=0)
                    else:
                        taps_all[name] = dict(t)
        return taps_all

    def layer_trace_inputs(self, cl, tap):
        """(W_mat (M, K) int, X_col (K, N) int) for one compressible layer."""
        if cl.kind == "conv":
            w_mat = conv_weight_matrix(tap["w_int"])
            x_col = im2col(tap["a_int"], (cl.kernel, cl.kernel), cl.stride,
                           cl.padding)
        else:
            w_mat = tap["w_int"].T  # dense w is (in, out) -> (M=out, K=in)
            x_col = tap["a_int"].reshape(-1, tap["a_int"].shape[-1]).T
        return w_mat, x_col

    def profile(self, params, state, comp, *, n_batches: int = 1,
                max_tiles: int = 24) -> Dict[str, LayerStats]:
        """Per-layer systolic trace statistics from captured activations:
        one transition-statistics launch per compressible layer, tiles
        sampled with the layer's `layer_seed`. The result is cached for
        `energy_models`. Each layer's tiles are split over ``profile_mesh``
        when it is set."""
        taps = self.capture_taps(params, state, comp, n_batches)
        out: Dict[str, LayerStats] = {}
        for cl in self.model.comp_layers:
            w_mat, x_col = self.layer_trace_inputs(cl, taps.pop(cl.name))
            out[cl.name] = profile_layer(w_mat, x_col, max_tiles=max_tiles,
                                         seed=layer_seed(cl.name),
                                         mesh=self.profile_mesh)
        self._stats_cache = out
        return out

    def layer_stats(self, params, state, comp,
                    **profile_kw) -> Dict[str, LayerStats]:
        """Cached per-layer stats; profiles on first use. Explicit
        ``profile_kw`` always re-profiles."""
        if self._stats_cache is None or profile_kw:
            self.profile(params, state, comp, **profile_kw)
        return self._stats_cache

    def _w_mat_int(self, params, comp, cl) -> torch.Tensor:
        w_int = qat.quantize_weight_int(self.model.get_weight(params, cl.name),
                                        comp[cl.name])
        return conv_weight_matrix(w_int) if cl.kind == "conv" else w_int.T

    def energy_models(self, params, comp,
                      stats: Optional[Dict[str, LayerStats]] = None,
                      batch: int = 1) -> Dict[str, LayerEnergyModel]:
        """LayerEnergyModel per compressible layer at inference batch size;
        ``stats=None`` uses the cache of the latest `profile` call."""
        if stats is None:
            stats = self._stats_cache
            if stats is None:
                raise ValueError(
                    "no LayerStats given and no cached profile: call "
                    "runner.profile(...) first or pass stats explicitly")
        out = {}
        for cl in self.model.comp_layers:
            dims = cl.matmul_dims(batch)
            lut = blended_lut(stats[cl.name].to(self.device))
            counts = weight_value_counts(self._w_mat_int(params, comp, cl),
                                         dims)
            out[cl.name] = LayerEnergyModel(cl.name, dims, lut, counts)
        return out

    def refresh_counts(self, params, comp,
                       models: Dict[str, LayerEnergyModel]
                       ) -> Dict[str, LayerEnergyModel]:
        """Recompute weight-value histograms after params/comp changed."""
        return {cl.name: self.refresh_layer_counts(params, comp, models,
                                                   cl.name)
                for cl in self.model.comp_layers}

    def refresh_layer_counts(self, params, comp,
                             models: Dict[str, LayerEnergyModel],
                             layer: str) -> LayerEnergyModel:
        """One layer's refreshed histogram."""
        m = models[layer]
        w_mat = self._w_mat_int(params, comp, self.model.comp_layer(layer))
        return m.with_counts(weight_value_counts(w_mat, m.dims))
