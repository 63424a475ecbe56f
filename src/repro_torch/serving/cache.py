"""Step cache for the serving engine (port of `repro.serving.cache`).

Two maps, both keyed on the engine identity ``(arch, fingerprint)`` — the
architecture name and the serving plan's *content fingerprint*
(`repro_torch.serving.fleet.comp_fingerprint`, hashing codebook values,
masks and ``msr_bits``), so two plans with equal k but different codebooks
or MSR settings never share steps or exported artifacts.

* ``(arch, fingerprint, shape-key)`` -> built steps. Wave/oneshot modes key
  on a `BucketSpec` and get a `CompiledStep` (prefill + lockstep decode);
  the slot-level engine keys on ``("group", batch, total_len)`` for its
  active-masked group decode (`GroupStep`) and on
  ``("chunk", rows, chunk, batch, total_len)`` for each chunked-prefill
  step (`ChunkStep`) — a small *fixed* set determined by the config's
  chunk buckets, never by request shapes.
* ``(arch, fingerprint)`` -> exported `ServeArtifact` tree + summary of the
  packed 4-bit deployment form (`repro_torch.core.lm_compress
  .export_lm_matmuls`).

The JAX package compiles each step ahead of time; here a step is a built
`_Step`: the model function with the shapes and dtypes of its tensor
arguments fixed when it is built, run once on zeros then (so the kernels'
libraries load and the first request pays no one-time cost), and raising
`TypeError` on a call of any other shape or dtype, as the JAX executable
does. ``compile_count`` counts builds, so "no builds after warmup" is the
same contract. The JAX step donates its input cache; here a step returns a
new cache and the engine drops the old one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch._device import DEFAULT_DEVICE, resolve_device, tree_leaves
from repro_torch.nn.layers import QuantConfig
from repro_torch.serving.bucketing import BucketSpec, EngineConfig


def _signature(tree):
    """(shape, dtype) of every tensor leaf of an argument tree."""
    return tuple((tuple(t.shape), t.dtype) for t in tree_leaves(tree))


class _Step:
    """A model step bound to fixed argument shapes: ``step(params, *args)``
    runs ``fn`` without autograd after checking every tensor of ``args``
    against the shapes and dtypes it was built with."""

    def __init__(self, fn: Callable, name: str, example_args: tuple):
        self.fn = fn
        self.name = name
        self.signature = _signature(example_args)

    def __call__(self, params, *args):
        got = _signature(args)
        if got != self.signature:
            raise TypeError(f"{self.name}: built for argument shapes "
                            f"{self.signature}, called with {got}")
        with torch.no_grad():
            return self.fn(params, *args)


@dataclasses.dataclass(frozen=True)
class CompiledStep:
    """Built steps for one bucket: ``prefill(params, prompts)`` -> (logits,
    cache); ``decode(params, cache, tok)`` -> (logits, cache)."""

    bucket: BucketSpec
    prefill: Callable
    decode: Callable


@dataclasses.dataclass(frozen=True)
class GroupStep:
    """Built decode for one slot group: ``decode(params, cache, tok,
    active)`` -> (logits, cache). Rows where ``active`` is False keep their
    cache and position; their logits are garbage. ``make_cache()`` returns a
    fresh zeroed group cache."""

    batch: int
    total_len: int
    decode: Callable
    make_cache: Callable


@dataclasses.dataclass(frozen=True)
class ChunkStep:
    """Built chunked-prefill step:
    ``fn(params, cache, tokens, rows, start, active)`` -> (logits, cache).

    Gathers ``rows`` (int32 (rows,)) out of the group cache, runs one
    prefill chunk per gathered row starting at ``start`` (int32 (rows,)),
    and scatters the updated rows back (``active`` masks padding rows).
    Logits are (rows, V) — each row's *last* chunk position only, which is
    all decode needs. Built per (row-width, chunk) pair from the config's
    fixed ``chunk_row_buckets`` x chunk-size grid."""

    rows: int
    chunk: int
    fn: Callable


class ServeCompileCache:
    """Per-(arch, plan-fingerprint) step + artifact cache on one device.
    Engine and oneshot serving apply the same discipline; the oneshot
    fallback warms batch-1 buckets (its wave width), so the two modes'
    bucket keys are disjoint."""

    def __init__(self, model, *, arch: str, fingerprint: str = "",
                 compress_k: int = 0, qcfg: Optional[QuantConfig] = None,
                 comp=None, config: EngineConfig = EngineConfig(),
                 device=DEFAULT_DEVICE):
        self.model = model
        self.arch = arch
        self.compress_k = int(compress_k)
        if not fingerprint:
            # direct construction without an explicit plan identity: derive
            # it from the comp content so distinct comps never share keys
            from repro_torch.serving.fleet import comp_fingerprint

            fingerprint = comp_fingerprint(comp)
        self.fingerprint = fingerprint
        self.qcfg = qcfg if qcfg is not None else QuantConfig.off()
        self.comp = comp
        self.config = config
        self.device = resolve_device(device)
        self._steps: Dict[Tuple, object] = {}
        self._artifacts: Dict[Tuple, Tuple[dict, dict]] = {}
        self._builds = 0
        self._replicas: Dict[torch.device, "ServeCompileCache"] = {}

    @property
    def compile_count(self) -> int:
        """Steps built by this cache and its `replica` caches."""
        return self._builds + sum(r._builds for r in self._replicas.values())

    def replica(self, device, comp) -> "ServeCompileCache":
        """This cache on another device, for a request mesh's shards there:
        the same identity and config, ``comp`` (the plan's comp tree on
        that device) for its steps. Its builds count in this cache's
        `compile_count`; ``device`` equal to this cache's returns self."""
        device = resolve_device(device)
        if device == self.device:
            return self
        if device not in self._replicas:
            self._replicas[device] = ServeCompileCache(
                self.model, arch=self.arch, fingerprint=self.fingerprint,
                compress_k=self.compress_k, qcfg=self.qcfg, comp=comp,
                config=self.config, device=device)
        return self._replicas[device]

    def _zeros(self, shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _build(self, fn: Callable, name: str, params, *example_args):
        """A `_Step` of ``fn`` at the example arguments' shapes, run once on
        them; returns (step, that run's output)."""
        step = _Step(fn, name, example_args)
        self._builds += 1
        return step, step(params, *example_args)

    # ------------------------------------------------------------ step fns

    def _key(self, bucket: BucketSpec) -> Tuple:
        return (self.arch, self.fingerprint, bucket.key())

    def fns(self, bucket: BucketSpec, params) -> CompiledStep:
        """Built (prefill, decode) for the bucket; builds on first use."""
        key = self._key(bucket)
        if key in self._steps:
            return self._steps[key]

        model, cfg = self.model, self.config
        qcfg, comp = self.qcfg, self.comp

        def prefill_fn(p, prompts):
            return model.prefill(p, prompts, bucket.total_len, qcfg=qcfg,
                                 comp=comp,
                                 cache_dtype=cfg.torch_cache_dtype,
                                 q_block=cfg.q_block, kv_block=cfg.kv_block)

        def decode_fn(p, cache, tok):
            return model.decode_step(p, cache, tok, qcfg=qcfg, comp=comp)

        prompts0 = self._zeros((bucket.batch, bucket.prompt_len))
        prefill, (_, cache0) = self._build(prefill_fn, f"prefill {key}",
                                           params, prompts0)
        tok0 = self._zeros((bucket.batch, 1))
        decode, _ = self._build(decode_fn, f"decode {key}", params, cache0,
                                tok0)
        step = CompiledStep(bucket=bucket, prefill=prefill, decode=decode)
        self._steps[key] = step
        return step

    # --------------------------------------------------- slot-group step fns

    def _group_shape(self) -> Tuple[int, int]:
        cfg = self.config
        return cfg.max_batch, cfg.group_total_len

    def _group_cache_zero(self):
        # fresh slots: per-row positions of 0 with an all-zero cache are
        # harmless (chunk prefill overwrites from position 0 before any
        # decode touches the row), so zeros are the right init
        batch, total_len = self._group_shape()
        return self.model.init_cache(batch, total_len,
                                     self.config.torch_cache_dtype,
                                     device=self.device)

    def group_fns(self, params) -> GroupStep:
        """Built active-masked decode for the slot group shape."""
        batch, total_len = self._group_shape()
        key = (self.arch, self.fingerprint, ("group", batch, total_len))
        if key in self._steps:
            return self._steps[key]

        model, qcfg, comp = self.model, self.qcfg, self.comp

        def decode_fn(p, cache, tok, active):
            return model.decode_step(p, cache, tok, qcfg=qcfg, comp=comp,
                                     active=active)

        decode, _ = self._build(decode_fn, f"group decode {key}", params,
                                self._group_cache_zero(),
                                self._zeros((batch, 1)),
                                self._zeros((batch,), torch.bool))
        step = GroupStep(batch=batch, total_len=total_len, decode=decode,
                         make_cache=self._group_cache_zero)
        self._steps[key] = step
        return step

    def chunk_fns(self, chunk: int, rows: int, params) -> ChunkStep:
        """Built chunked-prefill step for one (chunk size, row width) pair,
        operating on gathered group rows."""
        cfg = self.config
        batch, total_len = self._group_shape()
        rows = int(rows)
        key = (self.arch, self.fingerprint,
               ("chunk", rows, int(chunk), batch, total_len))
        if key in self._steps:
            return self._steps[key]

        model, qcfg, comp = self.model, self.qcfg, self.comp

        def chunk_fn(p, cache, tokens, row_ids, start, active):
            row_cache = model.gather_cache_rows(cache, row_ids)
            logits, new_rows = model.prefill_chunk(
                p, row_cache, tokens, start=start, qcfg=qcfg, comp=comp,
                q_block=cfg.q_block, kv_block=cfg.kv_block)
            new_cache = model.scatter_cache_rows(cache, row_ids, new_rows,
                                                 active)
            return logits[:, -1, :], new_cache

        fn, _ = self._build(chunk_fn, f"chunk {key}", params,
                            self._group_cache_zero(),
                            self._zeros((rows, int(chunk))),
                            self._zeros((rows,)), self._zeros((rows,)),
                            self._zeros((rows,), torch.bool))
        step = ChunkStep(rows=rows, chunk=int(chunk), fn=fn)
        self._steps[key] = step
        return step

    # ----------------------------------------------------------- artifacts

    def artifacts(self, params) -> Tuple[dict, dict]:
        """Packed `ServeArtifact` tree + footprint summary for
        (arch, fingerprint); empty when the engine is uncompressed."""
        key = (self.arch, self.fingerprint)
        if key in self._artifacts:
            return self._artifacts[key]
        if self.comp is None:
            arts: dict = {}
            summary = {"layers": 0, "weight_bytes_packed": 0}
        else:
            from repro_torch.core.export import export_summary
            from repro_torch.core.lm_compress import export_lm_matmuls

            arts, _skips = export_lm_matmuls(self.model, params, self.comp)
            summary = export_summary(arts)
        self._artifacts[key] = (arts, summary)
        return self._artifacts[key]

    # ------------------------------------------------------------- reports

    def stats(self) -> dict:
        return {
            "arch": self.arch,
            "compress_k": self.compress_k,
            "fingerprint": self.fingerprint,
            "buckets_compiled": len(self._steps) + sum(
                len(r._steps) for r in self._replicas.values()),
            "compile_count": self.compile_count,
        }
