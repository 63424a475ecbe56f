"""CNN evaluation and profiling runner of the compression pipeline (port of
`repro.core.runner`, without training yet).

Bundles a `CNNModel`, a synthetic dataset and one device. The compression
state ``comp`` ({layer_name: CompState}) is a plain argument of every
method. This slice ports what the ``profile`` and ``energy_model`` stages
run: parameter init, accuracy, the profiling taps, the per-layer trace
statistics (one transition-statistics kernel launch per layer) and the
per-layer energy models. QAT training and the candidate-sweep steps of the
schedule raise `NotImplementedError` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Optional

import torch

from repro_torch._device import DEFAULT_DEVICE, resolve_device, tree_map
from repro_torch.core import qat
from repro_torch.core.energy_lut import blended_lut
from repro_torch.core.layer_energy import LayerEnergyModel, weight_value_counts
from repro_torch.core.profiler import profile_layer
from repro_torch.core.stats import LayerStats, conv_weight_matrix, im2col
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.nn.cnn import CNNModel
from repro_torch.nn.layers import QuantConfig
from repro_torch.nn.spec import init_params

_TRAINING = ("ROADMAP.md Queue 1 item 3, the QAT/training slice (the "
             "optimizer, QAT steps and the schedule's candidate sweep)")


def layer_seed(name: str) -> int:
    """Tile-sampling seed of a layer: crc32 of its name (the JAX package's
    key; `str` hashes are salted per interpreter run)."""
    return zlib.crc32(name.encode()) % (2 ** 31)


@dataclasses.dataclass
class CnnRunner:
    model: CNNModel
    dataset: SyntheticImages
    batch_size: int = 128
    qcfg: QuantConfig = QuantConfig.on()
    seed: int = 0
    device: Any = DEFAULT_DEVICE

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._stats_cache: Optional[Dict[str, LayerStats]] = None

    # ------------------------------------------------------------------ setup

    def init(self):
        """(params, state, opt_state, comp) of a fresh model on the device."""
        params = init_params(self.seed, self.model.spec, self.device)
        state = init_params(self.seed, self.model.state_spec, self.device)
        # zero AdamW moments in the JAX optimizer's state layout, so a plan
        # written here resumes there
        opt_state = {"step": torch.zeros((), dtype=torch.int32,
                                         device=self.device),
                     "mu": tree_map(torch.zeros_like, params),
                     "nu": tree_map(torch.zeros_like, params)}
        return params, state, opt_state, self.identity_comp(params)

    def identity_comp(self, params) -> Dict[str, qat.CompState]:
        comp = {}
        for cl in self.model.comp_layers:
            w = self.model.get_weight(params, cl.name)
            comp[cl.name] = qat.identity_comp(tuple(w.shape), w.dtype,
                                              device=w.device)
        return comp

    # ------------------------------------------------------------------ train

    def train(self, *args, **kwargs):
        raise NotImplementedError(f"QAT training is not ported yet: {_TRAINING}")

    def train_batched(self, *args, **kwargs):
        raise NotImplementedError(f"not ported yet: {_TRAINING}")

    def accuracy_batched(self, *args, **kwargs):
        raise NotImplementedError(f"not ported yet: {_TRAINING}")

    def accuracy_comps(self, *args, **kwargs):
        raise NotImplementedError(f"not ported yet: {_TRAINING}")

    def accuracy_gather(self, *args, **kwargs):
        raise NotImplementedError(f"not ported yet: {_TRAINING}")

    def accuracy(self, params, state, comp, n_batches: int = 8,
                 split: str = "val") -> float:
        correct = 0
        with torch.no_grad():
            for i in range(n_batches):
                x, y = self.dataset.batch(i, self.batch_size, split,
                                          device=self.device)
                logits, _ = self.model.apply(params, state, x, train=False,
                                             qcfg=self.qcfg, comp=comp)
                correct += int((logits.argmax(-1) == y).sum())
        return correct / (n_batches * self.batch_size)

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
        `energy_models`."""
        taps = self.capture_taps(params, state, comp, n_batches)
        out: Dict[str, LayerStats] = {}
        for cl in self.model.comp_layers:
            w_mat, x_col = self.layer_trace_inputs(cl, taps.pop(cl.name))
            out[cl.name] = profile_layer(w_mat, x_col, max_tiles=max_tiles,
                                         seed=layer_seed(cl.name))
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
