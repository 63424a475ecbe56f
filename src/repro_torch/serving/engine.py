"""Continuous-batching serving engine over the compressed LM serving path
(port of `repro.serving.engine`).

``mode="engine"`` is slot-level continuous batching: requests enter a FIFO
queue and are admitted one *slot* at a time into persistent fixed-shape slot
groups (``max_batch`` rows x ``group_total_len`` cache positions, up to
``max_waves`` groups). The moment a slot's request finishes mid-decode it is
refilled from the queue head — no lockstep wave drain — and prompts are
prefilled in fixed-size *chunks* (``EngineConfig.chunk_buckets``) that
interleave with ongoing decode steps, so a long prompt never stalls the
group. Per-sequence positions in the decode cache (`repro_torch.models.lm`)
let every row sit at its own depth; an ``active`` mask keeps empty or
prefilling rows' state untouched during decode. Admission is strictly FIFO
over free slots, so a deep-queue request can never starve the queue head.

The no-builds-after-warmup contract: the slot engine builds one
active-masked group decode plus one chunked-prefill step per (chunk size,
row width) — a small set fixed by the config, independent of request
shapes — and every step rejects differently-shaped calls with a
``TypeError`` (`repro_torch.serving.cache`).

``mode="wave"`` is the wave-lockstep scheduler, kept as the measured
baseline: fixed-shape waves padded to a `BucketSpec` that prefill once and
decode in lockstep, early-finishing slots idling until the wave drains.
``mode="oneshot"`` is the single-shot fallback: the wave path restricted to
batch 1, one request at a time. All three modes share the bucket padding
contract and host-side sampling (greedy *and* seeded-temperature draws are a
pure function of the request's seed), and every row's result is a function
of that row alone: the engine's forward is ``QuantConfig.batch_invariant``
(products and sums round once from float64: K2, `exact_matmul`; a
compressed plan's activations fake-quantized with one scale a token
position). So cross-mode output parity holds token for token, uncompressed
and compressed, fake-quant and LUT. This is where the port departs from
the JAX package by design: its engine quantizes with one scale a call,
which couples a request to its batch-mates, padding and chunking, so on a
compressed plan the two packages' served tokens may differ (and JAX's own
engine and oneshot fallback may disagree).

A compressed plan runs the fake-quant forward (one grouped K3 launch a
step: `LMModel._fake_quant_units`) or, with ``EngineConfig.lut_serve``,
the packed 4-bit artifacts on the LUT GEMM (K2, one launch an exported
matmul: 7 a dense layer, 2 a Mamba-2 layer, 8 an RG-LRU layer), each in
the configuration K2's tuner resolves; ``EngineConfig.autotune_cache``
loads the tuner's cache at construction and saves it after `warmup`. A
recurrent model (rglru/ssm blocks) prefills each prompt bucket in one
chunk from the mixer's zero state (`_check_chunkable`), as the JAX
package's engine does.

Accounting prices the compute actually performed: ``executed_positions``
counts every padded/idle position pushed through the array (prefill rows x
padded length, chunk rows x chunk, decode batch per step); `metrics
.summarize` reports the gap to the per-request charge as
``energy_eu_overhead`` and a ``slot_utilization`` ratio.

The engine serves exactly one compression variant, identified by a
`repro_torch.serving.fleet.PlanHandle` (``plan=``) whose content
fingerprint keys the step and artifact cache. ``ServingEngine(compress_k=
...)`` survives as a deprecated shim that builds the uniform-restriction
handle.

``mesh=`` takes a 1-D ("requests",) mesh
(`repro_torch.distributed.sharding.request_mesh`). A wave or oneshot batch
whose row count divides the mesh size is split over it: each shard's rows
run the bucket's built step (built at the shard's row count) on the
shard's device, with one copy of the params and the plan's comp tree a
distinct device (shards on the same device share it, and run one after
another), and the logits come back concatenated in row order on the
mesh's first device. Other batches, and the slot path (``mode="engine"``,
whose row gathers and scatters would cross shards), run on the first
device, as the JAX package runs them replicated. A row's result does not
depend on its batch-mates (``batch_invariant``), so the sharded tokens and
logits equal the unsharded ones bit for bit.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE, resolve_device, tree_to
from repro_torch.distributed.sharding import (
    REQUEST_AXIS,
    check_mesh,
    device_scope,
    to_device,
)
from repro_torch.kernels.lut_matmul.autotune import get_default_autotuner
from repro_torch.nn.layers import QuantConfig
from repro_torch.nn.transformer import RECURRENT
from repro_torch.serving.bucketing import (
    BucketSpec,
    EngineConfig,
    bucket_for,
    bucket_up,
    chunk_plan,
    pad_prompts,
)
from repro_torch.serving.cache import ServeCompileCache
from repro_torch.serving.fleet import PlanHandle
from repro_torch.serving.metrics import RequestStats, per_token_energy, summarize


@dataclasses.dataclass(frozen=True)
class RequestBudget:
    """Per-request SLO caps. ``energy_eu_per_token`` bounds the serving
    variant's measured per-token MAC energy (a routing input for a fleet);
    ``latency_s`` bounds end-to-end request latency (evaluated post-hoc for
    the SLO hit-rate)."""

    energy_eu_per_token: Optional[float] = None
    latency_s: Optional[float] = None


@dataclasses.dataclass
class ServeRequest:
    """One serving request, the unit `ServingEngine.serve` accepts.
    ``tokens`` is the prompt; ``tenant`` and ``budget`` feed a fleet's
    accounting and routing and are inert for a pinned engine."""

    tokens: Sequence[int]
    max_new_tokens: int
    tenant: str = "default"
    budget: Optional[RequestBudget] = None
    temperature: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    tenant: str = "default"
    budget: Optional[RequestBudget] = None


@dataclasses.dataclass
class ServeResult:
    rid: int
    tokens: List[int]             # exactly new_tokens entries
    stats: RequestStats


# the pre-fleet name; old call sites keep working unchanged
RequestResult = ServeResult


class _Slot:
    """One request's in-flight state (wave slot or slot-group row)."""

    def __init__(self, req: Request, stats: RequestStats):
        self.req = req
        self.stats = stats
        self.tokens: List[int] = []
        # the sampling stream is a pure function of the request's own seed
        # (not of engine-local ids), so all modes' draws agree
        self.rng = np.random.default_rng(req.seed)
        # chunked-prefill state (slot mode only)
        self.chunks: List[np.ndarray] = []
        self.next_chunk = 0
        self.start = 0                # padded positions already prefilled

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.req.new_tokens

    @property
    def prefilling(self) -> bool:
        return self.next_chunk < len(self.chunks)


@dataclasses.dataclass(frozen=True)
class _WaveFns:
    """A wave bucket's built steps on host arrays: ``prefill(prompts)`` ->
    (logits, cache), ``decode(cache, tok)`` -> (logits, cache); int32 numpy
    in, logits on the engine's device out."""

    prefill: Callable
    decode: Callable


class _Wave:
    """A fixed-shape micro-batch mid-decode (wave/oneshot modes)."""

    def __init__(self, bucket: BucketSpec, slots: List[_Slot],
                 fns: _WaveFns, cache, tok: np.ndarray):
        self.bucket = bucket
        self.slots = slots
        self.fns = fns
        self.cache = cache        # one cache a request shard under a mesh
        self.tok = tok            # (batch, 1) int32 host array

    @property
    def done(self) -> bool:
        return all(s.done for s in self.slots)


class _SlotGroup:
    """A persistent fixed-shape row group for slot-level batching."""

    def __init__(self, step, cache):
        self.step = step          # cache.GroupStep
        self.cache = cache
        self.slots: List[Optional[_Slot]] = [None] * step.batch
        self.tok = np.zeros((step.batch, 1), np.int32)

    @property
    def busy(self) -> bool:
        return any(s is not None for s in self.slots)


class ServingEngine:
    """Queue + micro-batcher + step cache over one LM and its params, on one
    device (``"cuda"`` unless the caller asks for ``"cpu"``; the params and
    the plan's comp tree are moved there), or with ``mesh=`` on the request
    mesh's first device, wave rows split over its shards."""

    def __init__(self, model, params, *, mode: str = "engine",
                 config: EngineConfig = EngineConfig(), plan=None,
                 compress_k: Optional[int] = None, comp=None,
                 arch: Optional[str] = None, mesh=None,
                 device=DEFAULT_DEVICE):
        if mode not in ("engine", "wave", "oneshot"):
            raise ValueError(
                f"mode must be 'engine', 'wave' or 'oneshot', got {mode!r}")
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            check_mesh(mesh, REQUEST_AXIS)
            if mesh.first.type != self.device.type:
                raise ValueError(f"device {str(self.device)!r} but the "
                                 f"request mesh starts on {mesh.first}")
            self.device = mesh.first
        self.model = model
        self.config = config
        self.mode = mode
        self.arch = arch if arch is not None else model.cfg.name

        if plan is not None:
            if compress_k is not None or comp is not None:
                raise ValueError(
                    "pass either plan= or the deprecated compress_k=/comp=, "
                    "not both")
        elif compress_k is not None or comp is not None:
            warnings.warn(
                "ServingEngine(compress_k=..., comp=...) is deprecated; "
                "construct a repro_torch.serving.fleet.PlanHandle and pass "
                "plan=handle",
                DeprecationWarning, stacklevel=2)
            k = int(compress_k or 0)
            if comp is not None:
                plan = PlanHandle.from_comp(
                    comp, compress_k=k, plan_id=f"k{k}" if k else "custom")
            else:
                plan = PlanHandle.from_compress_k(model, k,
                                                  device=self.device)
        else:
            plan = PlanHandle.uncompressed()

        params = tree_to(params, self.device)
        self.plan = plan
        self.comp = tree_to(plan.comp, self.device)
        self.compress_k = int(plan.compress_k)
        self.serve_units = 0
        if self.comp is None:
            qcfg = QuantConfig.off()
        elif config.lut_serve:
            # packed-LUT serving: attach 4-bit serve artifacts to the plan's
            # comp tree and dispatch eligible matmuls to the LUT GEMM (K2);
            # the fingerprint is fixed already (artifacts are derived
            # content and excluded from comp hashing)
            from repro_torch.core.lm_compress import attach_serve_artifacts

            if config.autotune_cache and os.path.exists(config.autotune_cache):
                get_default_autotuner().load(config.autotune_cache)
            self.comp, self.serve_units = attach_serve_artifacts(
                model, params, self.comp)
            if self.serve_units == 0:
                raise ValueError(
                    "lut_serve=True but no eligible unit in the plan's comp "
                    "tree is 4-bit servable (every codebook needs "
                    "0 < k <= 16)")
            qcfg = QuantConfig.serve()
        else:
            qcfg = QuantConfig.on()
        self.qcfg = dataclasses.replace(qcfg, batch_invariant=True)
        self.params = params

        self._single_chunk_only = False
        if mode == "engine":
            self._check_chunkable()

        self.cache = ServeCompileCache(
            model, arch=self.arch, fingerprint=plan.fingerprint,
            compress_k=self.compress_k, qcfg=self.qcfg, comp=self.comp,
            config=config, device=self.device)
        # (params, step cache) a distinct device of the request mesh
        self._replicas = {self.device: (self.params, self.cache)}
        for dev in (mesh.distinct() if mesh is not None else ()):
            if dev not in self._replicas:
                self._replicas[dev] = (
                    to_device(params, dev),
                    self.cache.replica(dev, to_device(self.comp, dev)))

        self._queue: collections.deque[Request] = collections.deque()
        self._waves: List[_Wave] = []
        self._groups: List[_SlotGroup] = []
        self._next_rid = 0
        self._stats_pending: Dict[int, RequestStats] = {}
        self._completed: Dict[int, RequestResult] = {}
        self._e_per_token: Optional[float] = None
        self.executed_positions = 0
        self.last_wall_s = 0.0
        self.total_wall_s = 0.0

    # --------------------------------------------------------- chunk gating

    def _check_chunkable(self) -> None:
        """Slot mode needs the chunk path; reject models it cannot serve.
        Every attention window must cover the group cache (a chunk cannot
        write through a ring buffer). Recurrent mixers (rglru/ssm) have no
        mid-sequence state injection, so every prompt bucket must be one
        chunk: explicit chunk buckets that split one raise, and without
        them each prompt bucket is its own chunk (``_single_chunk_only``),
        the JAX package's rule. Encoder-decoder models have no chunk path
        at all."""
        cfg, ecfg = self.model.cfg, self.config
        if cfg.encoder_decoder:
            raise ValueError("slot-level batching has no chunk path for "
                             "encoder-decoder models; use mode='wave' or "
                             "'oneshot'")
        for bt in set(cfg.pattern):
            if bt in ("attn", "local"):
                window = cfg.attn_dims(bt == "local").window
                if 0 < window < ecfg.group_total_len:
                    raise ValueError(
                        f"slot-level batching needs the attention window "
                        f"({window}) to cover the group cache "
                        f"({ecfg.group_total_len}): chunked prefill cannot "
                        f"write through a ring buffer; use mode='wave'")
        recurrent = any(bt in RECURRENT for bt in cfg.pattern)
        if recurrent and ecfg.chunk_buckets is not None:
            for p in ecfg.prompt_buckets:
                if chunk_plan(p, ecfg.chunk_buckets) != (p,):
                    raise ValueError(
                        "recurrent mixers (rglru/ssm) have no mid-sequence "
                        "state injection: chunk buckets must give every "
                        "prompt bucket a single-chunk plan")
        self._single_chunk_only = recurrent and ecfg.chunk_buckets is None

    def _chunk_plan(self, padded_prompt: int) -> tuple:
        if self._single_chunk_only:
            return (padded_prompt,)
        return chunk_plan(padded_prompt, self.config.resolved_chunk_buckets)

    def _chunk_sizes(self) -> set:
        """The fixed step set: every chunk size any prompt bucket plan
        uses."""
        sizes = set()
        for p in self.config.prompt_buckets:
            sizes.update(self._chunk_plan(p))
        return sizes

    # ------------------------------------------------------------ placement

    def _place(self, x) -> torch.Tensor:
        """A host array as a tensor on the engine's device."""
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _wave_fns(self, bucket: BucketSpec) -> _WaveFns:
        """The bucket's built steps, split over the request mesh when its
        rows divide the mesh size (builds on first use)."""
        n = 1 if self.mesh is None else self.mesh.size
        if n == 1 or bucket.batch % n:
            step = self.cache.fns(bucket, self.params)
            return _WaveFns(
                prefill=lambda prompts: step.prefill(self.params,
                                                     self._place(prompts)),
                decode=lambda cache, tok: step.decode(self.params, cache,
                                                      self._place(tok)))
        rows = bucket.batch // n
        shard = dataclasses.replace(bucket, batch=rows)
        shards = []
        for i, dev in enumerate(self.mesh.devices):
            params, cache = self._replicas[dev]
            shards.append((slice(i * rows, (i + 1) * rows), dev, params,
                           cache.fns(shard, params)))

        def run(call, x, caches):
            logits, new = [], []
            for (sl, dev, params, step), c in zip(shards, caches):
                with device_scope(dev):
                    out = call(step, params, c, torch.as_tensor(
                        np.asarray(x[sl]), device=dev))
                logits.append(out[0].to(self.device))
                new.append(out[1])
            return torch.cat(logits), new

        return _WaveFns(
            prefill=lambda prompts: run(
                lambda st, p, _c, x: st.prefill(p, x), prompts,
                [None] * n),
            decode=lambda caches, tok: run(
                lambda st, p, c, x: st.decode(p, c, x), tok, caches))

    @staticmethod
    def _host(logits: torch.Tensor, vocab: int) -> np.ndarray:
        """Logits rows (..., V) as float32 numpy over the real vocab."""
        return logits[..., :vocab].float().cpu().numpy()

    # ------------------------------------------------------------ admission

    @property
    def wave_width(self) -> int:
        return 1 if self.mode == "oneshot" else self.config.max_batch

    @property
    def max_inflight(self) -> int:
        """Oneshot means one request at a time — no wave overlap either."""
        return 1 if self.mode == "oneshot" else self.config.max_waves

    def submit(self, prompt: Sequence[int], new_tokens: int, *,
               temperature: float = 0.0, seed: int = 0,
               tenant: str = "default",
               budget: Optional[RequestBudget] = None) -> int:
        """Enqueue one request; returns its request id."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, new_tokens=int(new_tokens),
                      temperature=float(temperature), seed=int(seed),
                      tenant=str(tenant), budget=budget)
        # validates the shape fits a bucket at submit time, not mid-run
        bucket_for(prompt.shape[0], req.new_tokens, self.config,
                   self.wave_width)
        self._queue.append(req)
        self._stats_pending[rid] = RequestStats(
            rid=rid, prompt_len=int(prompt.shape[0]),
            new_tokens=req.new_tokens, bucket=(),
            t_submit=time.perf_counter(), tenant=req.tenant,
            plan_id=self.plan.plan_id)
        return rid

    def submit_request(self, request: ServeRequest) -> int:
        """Enqueue one `ServeRequest`; returns its request id."""
        return self.submit(request.tokens, request.max_new_tokens,
                           temperature=request.temperature,
                           seed=request.seed, tenant=request.tenant,
                           budget=request.budget)

    @property
    def pending(self) -> int:
        """Requests submitted but not yet finished (queued + in flight)."""
        n = len(self._queue)
        if self.mode == "engine":
            n += sum(1 for g in self._groups for s in g.slots
                     if s is not None)
        else:
            n += sum(1 for w in self._waves for s in w.slots if not s.done)
        return n

    def result(self, rid: int) -> Optional[ServeResult]:
        """The finished result for ``rid``, or None while it is in flight."""
        return self._completed.get(rid)

    def warmup(self, shapes: Sequence[tuple]) -> dict:
        """Build every step serving the (prompt_len, new_tokens) shapes
        needs, plus the per-token energy model; returns cache stats. After
        warmup, serving those shapes adds zero builds. In slot mode the step
        set (group decode + one step per chunk size and row width) is fixed
        by the config, so warmup builds it all regardless of the shapes."""
        for plen, ntok in shapes:
            bucket = bucket_for(plen, ntok, self.config, self.wave_width)
            if self.mode != "engine":
                self._wave_fns(bucket)
        if self.mode == "engine":
            self.cache.group_fns(self.params)
            for size in sorted(self._chunk_sizes()):
                for rows in self.config.chunk_row_buckets:
                    self.cache.chunk_fns(size, rows, self.params)
        _ = self.per_token_energy_eu
        if self.config.lut_serve and self.config.autotune_cache:
            # the configurations resolved while building, for a warm restart
            get_default_autotuner().save(self.config.autotune_cache)
        return self.cache.stats()

    def _sample_row(self, row: np.ndarray, slot: Optional[_Slot]) -> int:
        """Host-side sampling — shared by all modes, so parity is exact."""
        if slot is None or slot.req.temperature <= 0.0:
            return int(np.argmax(row))
        z = row / slot.req.temperature
        z = z - np.max(z)
        p = np.exp(z)
        p /= np.sum(p)
        return int(slot.rng.choice(row.shape[0], p=p))

    def _admit(self) -> bool:
        """Form one wave from the queue head's bucket; False if queue empty.

        Wave/oneshot only: scans the whole queue for bucket-mates of the
        head request (the head itself is always admitted, so the scan cannot
        starve it)."""
        if not self._queue:
            return False
        width = self.wave_width
        head = self._queue[0]
        bucket = bucket_for(head.prompt.shape[0], head.new_tokens,
                            self.config, width)
        taken: List[Request] = []
        kept: collections.deque = collections.deque()
        while self._queue:
            r = self._queue.popleft()
            same = bucket_for(r.prompt.shape[0], r.new_tokens, self.config,
                              width) == bucket
            if same and len(taken) < width:
                taken.append(r)
            else:
                kept.append(r)
        self._queue = kept

        fns = self._wave_fns(bucket)
        prompts = pad_prompts([r.prompt for r in taken], bucket,
                              self.config.pad_token)
        t_admit = time.perf_counter()
        logits, kv = fns.prefill(prompts)
        self.executed_positions += bucket.batch * bucket.prompt_len
        last = self._host(logits[:, -1], self.model.cfg.vocab)

        slots: List[_Slot] = []
        tok = np.zeros((bucket.batch, 1), np.int32)
        t_first = time.perf_counter()
        for i in range(bucket.batch):
            slot = None
            if i < len(taken):
                stats = self._stats_pending.pop(taken[i].rid)
                stats.bucket = bucket.key()
                stats.t_admitted = t_admit
                slot = _Slot(taken[i], stats)
                slots.append(slot)
            tok[i, 0] = self._sample_row(last[i], slot)
            if slot is not None:
                slot.tokens.append(int(tok[i, 0]))
                slot.stats.t_first_token = t_first
        wave = _Wave(bucket, slots, fns, kv, tok)
        self._finish_done(wave)
        if not wave.done:
            self._waves.append(wave)
        return True

    # ------------------------------------------------- decode (wave modes)

    def _step(self, wave: _Wave) -> None:
        logits, wave.cache = wave.fns.decode(wave.cache, wave.tok)
        self.executed_positions += wave.bucket.batch
        rows = self._host(logits[:, 0], self.model.cfg.vocab)
        tok = np.zeros((wave.bucket.batch, 1), np.int32)
        t = time.perf_counter()
        for i in range(wave.bucket.batch):
            slot = wave.slots[i] if i < len(wave.slots) else None
            active = slot is not None and not slot.done
            tok[i, 0] = self._sample_row(rows[i], slot if active else None)
            if active:
                slot.tokens.append(int(tok[i, 0]))
                if slot.done:
                    slot.stats.t_finish = t
        wave.tok = tok
        self._finish_done(wave)

    def _finish_done(self, wave: _Wave) -> None:
        t = time.perf_counter()
        for slot in wave.slots:
            if slot.done and slot.req.rid not in self._completed:
                if slot.stats.t_finish is None:
                    slot.stats.t_finish = t
                self._complete(slot)
        if wave.done and wave in self._waves:
            self._waves.remove(wave)

    def _complete(self, slot: _Slot) -> None:
        slot.stats.energy_eu = (
            self.per_token_energy_eu
            * (slot.stats.prompt_len + slot.stats.new_tokens))
        self._completed[slot.req.rid] = RequestResult(
            rid=slot.req.rid, tokens=slot.tokens, stats=slot.stats)

    # ------------------------------------------------- scheduler (slot mode)

    def _make_slot(self, req: Request) -> _Slot:
        stats = self._stats_pending.pop(req.rid)
        cfg = self.config
        p = bucket_up(req.prompt.shape[0], cfg.prompt_buckets)
        n = bucket_up(req.new_tokens, cfg.new_token_buckets)
        stats.bucket = (1, p, p + n)    # slot-level: one row, own depths
        stats.t_admitted = time.perf_counter()
        slot = _Slot(req, stats)
        padded = np.full((p,), cfg.pad_token, np.int32)
        padded[:req.prompt.shape[0]] = req.prompt
        off = 0
        for size in self._chunk_plan(p):
            slot.chunks.append(padded[off:off + size])
            off += size
        return slot

    def _refill_slots(self) -> None:
        """Strict-FIFO admission into free slots; grows the group list up to
        ``max_waves`` groups when the queue still has depth."""
        for g in self._groups:
            for i in range(g.step.batch):
                if not self._queue:
                    return
                if g.slots[i] is None:
                    g.slots[i] = self._make_slot(self._queue.popleft())
        while self._queue and len(self._groups) < self.max_inflight:
            step = self.cache.group_fns(self.params)
            g = _SlotGroup(step, step.make_cache())
            self._groups.append(g)
            for i in range(g.step.batch):
                if not self._queue:
                    break
                g.slots[i] = self._make_slot(self._queue.popleft())

    def _chunk_steps(self, g: _SlotGroup) -> bool:
        """Advance every prefilling slot of the group by one chunk."""
        pending = [i for i, s in enumerate(g.slots)
                   if s is not None and s.prefilling]
        if not pending:
            return False
        by_size: Dict[int, List[int]] = {}
        for i in pending:
            s = g.slots[i]
            by_size.setdefault(len(s.chunks[s.next_chunk]), []).append(i)
        cap = self.config.resolved_chunk_rows
        for size, rows in sorted(by_size.items()):
            for j0 in range(0, len(rows), cap):
                batch = rows[j0:j0 + cap]
                # narrowest built row width that fits this refill batch, so
                # a single freed slot costs a 1-row chunk step
                width = bucket_up(len(batch), self.config.chunk_row_buckets)
                self._chunk_call(g, self.cache.chunk_fns(size, width,
                                                         self.params), batch)
        return True

    def _chunk_call(self, g: _SlotGroup, step, rows: List[int]) -> None:
        size, n_rows = step.chunk, step.rows
        toks = np.full((n_rows, size), self.config.pad_token, np.int32)
        row_ids = np.zeros((n_rows,), np.int32)
        start = np.zeros((n_rows,), np.int32)
        active = np.zeros((n_rows,), bool)
        for j, r in enumerate(rows):
            s = g.slots[r]
            toks[j] = s.chunks[s.next_chunk]
            row_ids[j], start[j], active[j] = r, s.start, True
        logits, g.cache = step.fn(
            self.params, g.cache, self._place(toks), self._place(row_ids),
            self._place(start), self._place(active))
        self.executed_positions += n_rows * size
        finishing = [j for j, r in enumerate(rows)
                     if g.slots[r].next_chunk + 1 == len(g.slots[r].chunks)]
        last = None
        if finishing:
            last = self._host(logits, self.model.cfg.vocab)
        t = time.perf_counter()
        for j, r in enumerate(rows):
            s = g.slots[r]
            s.next_chunk += 1
            s.start += size
            if not s.prefilling:
                tok = self._sample_row(last[j], s)
                s.tokens.append(tok)
                s.stats.t_first_token = t
                g.tok[r, 0] = tok
                if s.done:
                    s.stats.t_finish = t
                    self._complete(s)
                    g.slots[r] = None

    def _decode_group(self, g: _SlotGroup) -> bool:
        """One decode step over the group's rows that hold decoding slots."""
        rows = [i for i, s in enumerate(g.slots)
                if s is not None and not s.prefilling]
        if not rows:
            return False
        act = np.zeros((g.step.batch,), bool)
        act[rows] = True
        logits, g.cache = g.step.decode(
            self.params, g.cache, self._place(g.tok), self._place(act))
        self.executed_positions += g.step.batch
        out = self._host(logits[:, 0], self.model.cfg.vocab)
        t = time.perf_counter()
        for r in rows:
            s = g.slots[r]
            tok = self._sample_row(out[r], s)
            s.tokens.append(tok)
            g.tok[r, 0] = tok
            if s.done:
                s.stats.t_finish = t
                self._complete(s)
                g.slots[r] = None
        return True

    # ----------------------------------------------------------------- run

    def step(self) -> bool:
        """Advance the scheduler by one iteration; False when idle.

        One iteration is one refill + chunk + decode pass (slot mode) or one
        admit + lockstep-decode pass (wave/oneshot)."""
        if self.mode == "engine":
            if not (self._queue or any(g.busy for g in self._groups)):
                return False
            self._refill_slots()
            for g in self._groups:
                self._chunk_steps(g)
            for g in self._groups:
                self._decode_group(g)
            return True
        if not (self._queue or self._waves):
            return False
        while self._queue and len(self._waves) < self.max_inflight:
            if not self._admit():
                break
        for wave in list(self._waves):
            self._step(wave)
        return True

    def run(self) -> Dict[int, ServeResult]:
        """Drain the queue: admit + decode until every request completes."""
        t0 = time.perf_counter()
        while self.step():
            pass
        self.last_wall_s = time.perf_counter() - t0
        self.total_wall_s += self.last_wall_s
        return dict(self._completed)

    def serve(self, requests: Union[Sequence[ServeRequest],
                                    Sequence[Sequence[int]]],
              new_tokens=None):
        """Submit a batch and run it to completion.

        The current form takes a sequence of `ServeRequest` and returns the
        `ServeResult`s **in submission order** (a list). The pre-fleet form
        ``serve(prompts, new_tokens)`` still works — it constructs requests
        internally and returns the old ``{rid: ServeResult}`` dict — but
        emits a DeprecationWarning.
        """
        requests = list(requests)
        if new_tokens is None and all(isinstance(r, ServeRequest)
                                      for r in requests):
            rids = [self.submit_request(r) for r in requests]
            out = self.run()
            return [out[rid] for rid in rids]
        warnings.warn(
            "ServingEngine.serve(prompts, new_tokens) is deprecated; pass a "
            "sequence of ServeRequest",
            DeprecationWarning, stacklevel=2)
        if new_tokens is None:
            raise ValueError(
                "serve() needs ServeRequest entries or (prompts, new_tokens)")
        if isinstance(new_tokens, int):
            new_tokens = [new_tokens] * len(requests)
        if len(new_tokens) != len(requests):
            raise ValueError(
                f"got {len(requests)} prompts but {len(new_tokens)} "
                f"new_tokens entries; zip would silently drop requests")
        rids = [self.submit(p, n) for p, n in zip(requests, new_tokens)]
        out = self.run()
        return {rid: out[rid] for rid in rids}

    # -------------------------------------------------------------- reports

    @property
    def per_token_energy_eu(self) -> float:
        if self._e_per_token is None:
            self._e_per_token = per_token_energy(self.model, self.params,
                                                 self.comp)
        return self._e_per_token

    def artifacts(self):
        """Packed `ServeArtifact` tree + footprint summary (compressed only)."""
        return self.cache.artifacts(self.params)

    def report(self) -> dict:
        """Aggregate over every request completed so far (throughput uses the
        cumulative wall time of all `run()` calls)."""
        stats = [r.stats for r in self._completed.values()]
        return summarize(stats, self.total_wall_s, self.cache.stats(),
                         executed_positions=self.executed_positions,
                         per_token_energy_eu=self.per_token_energy_eu)
