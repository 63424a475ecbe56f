"""Shape buckets for the continuous-batching serving engine (port of
`repro.serving.bucketing`).

The engine never builds a step per request: every request is mapped to a
`BucketSpec` — a fixed ``(batch, prompt_len, total_len)`` triple — and the
step cache holds exactly one (prefill, decode) step pair per bucket.
Prompts are right-padded with ``pad_token`` up to the bucket prompt length
and generation starts at position ``prompt_len`` (the padded length) for
every request in the bucket; batches are padded with inert dummy rows. This
"pad-to-bucket" contract is part of the serving semantics (the fixed-shape
engine has no per-token attention masking), and it is shared by
``mode="engine"``, ``"wave"`` and the ``"oneshot"`` fallback, so the modes
stay output-identical. A request whose prompt exactly fills its bucket
reproduces the unpadded `repro_torch.launch.serve.generate` path exactly
(tested).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# EngineConfig.cache_dtype strings and the torch dtypes they name
CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "float64": torch.float64}

@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One fixed step shape: batch rows, padded prompt, total cache len."""

    batch: int
    prompt_len: int     # padded prompt length (generation starts here)
    total_len: int      # prompt_len + padded new-token budget

    @property
    def new_tokens(self) -> int:
        return self.total_len - self.prompt_len

    def key(self) -> Tuple[int, int, int]:
        return (self.batch, self.prompt_len, self.total_len)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine knobs (hashable; part of no step key — buckets are).

    Validated in ``__post_init__``: bucket tuples must be non-empty tuples of
    distinct positive ints and the scalar knobs must be >= 1, so a bad config
    fails at construction instead of as a confusing `bucket_up` or build
    error mid-serve.

    ``cache_dtype`` names a torch dtype (`CACHE_DTYPES`, `torch_cache_dtype`).
    ``lut_serve`` dispatches compressed plans to the packed 4-bit LUT GEMM
    (K2). ``lut_use_ref`` is accepted so configs cross-load with the JAX
    package and selects nothing: CPU tensors take the plain LUT GEMM and
    CUDA tensors launch the kernel. ``autotune_cache``: a path (string) for
    K2's configuration tuner (`repro_torch.kernels.lut_matmul.autotune`);
    with ``lut_serve`` the engine loads it into the process-wide tuner at
    construction (when the file exists) and saves the tuner there after
    `warmup`, so a warm restart resolves its shapes with zero retunes.
    """

    max_batch: int = 8                 # slot-group width (wave width in wave mode)
    prompt_buckets: Tuple[int, ...] = (16, 32, 64)
    new_token_buckets: Tuple[int, ...] = (16, 32)
    max_waves: int = 2                 # in-flight slot groups / decode waves
    pad_token: int = 0
    q_block: int = 8                   # prefill attention tiling
    kv_block: int = 8
    cache_dtype: str = "float32"
    # chunked prefill: sizes a padded prompt bucket is split into (None ->
    # one size, the gcd of the prompt buckets) and how many rows one chunk
    # step carries (0 -> max(1, max_batch // 2))
    chunk_buckets: Optional[Tuple[int, ...]] = None
    chunk_rows: int = 0
    lut_serve: bool = False
    lut_use_ref: Optional[bool] = None
    autotune_cache: Optional[str] = None

    def __post_init__(self):
        if not isinstance(self.lut_serve, bool):
            raise ValueError(f"EngineConfig.lut_serve must be a bool, "
                             f"got {self.lut_serve!r}")
        if self.lut_use_ref is not None \
                and not isinstance(self.lut_use_ref, bool):
            raise ValueError(f"EngineConfig.lut_use_ref must be None or a "
                             f"bool, got {self.lut_use_ref!r}")
        if self.autotune_cache is not None:
            if not isinstance(self.autotune_cache, str):
                raise ValueError(f"EngineConfig.autotune_cache must be None "
                                 f"or a path string, got "
                                 f"{self.autotune_cache!r}")
        if self.cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"EngineConfig.cache_dtype must be one of "
                             f"{sorted(CACHE_DTYPES)}, got "
                             f"{self.cache_dtype!r}")
        for name in ("max_batch", "max_waves", "q_block", "kv_block"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(f"EngineConfig.{name} must be an int >= 1, "
                                 f"got {v!r}")
        if not isinstance(self.chunk_rows, int) \
                or isinstance(self.chunk_rows, bool) or self.chunk_rows < 0:
            raise ValueError(f"EngineConfig.chunk_rows must be an int >= 0 "
                             f"(0 = auto), got {self.chunk_rows!r}")
        _check_bucket_tuple("prompt_buckets", self.prompt_buckets)
        _check_bucket_tuple("new_token_buckets", self.new_token_buckets)
        if self.chunk_buckets is not None:
            _check_bucket_tuple("chunk_buckets", self.chunk_buckets)
            for p in self.prompt_buckets:
                chunk_plan(p, self.chunk_buckets)   # raises if no exact cover

    @property
    def torch_cache_dtype(self) -> torch.dtype:
        return CACHE_DTYPES[self.cache_dtype]

    @property
    def resolved_chunk_buckets(self) -> Tuple[int, ...]:
        if self.chunk_buckets is not None:
            return tuple(sorted(self.chunk_buckets))
        return (functools.reduce(math.gcd, self.prompt_buckets),)

    @property
    def resolved_chunk_rows(self) -> int:
        rows = self.chunk_rows or max(1, self.max_batch // 2)
        return min(rows, self.max_batch)

    @property
    def chunk_row_buckets(self) -> Tuple[int, ...]:
        """Row widths the chunk steps are built at: powers of two up to
        ``resolved_chunk_rows`` (plus the cap itself). Refilling a single
        freed slot then costs a 1-row chunk, not a full-width one."""
        cap = self.resolved_chunk_rows
        out = []
        r = 1
        while r < cap:
            out.append(r)
            r *= 2
        out.append(cap)
        return tuple(out)

    @property
    def group_total_len(self) -> int:
        """Cache length of one slot group: any admissible request fits."""
        return max(self.prompt_buckets) + max(self.new_token_buckets)

    @property
    def slot_capacity(self) -> int:
        """Concurrent requests one engine can hold in flight (all groups
        full)."""
        return self.max_batch * self.max_waves


def _check_bucket_tuple(name: str, t) -> None:
    if not isinstance(t, tuple) or not t:
        raise ValueError(f"EngineConfig.{name} must be a non-empty tuple, "
                         f"got {t!r}")
    for b in t:
        if not isinstance(b, int) or isinstance(b, bool) or b < 1:
            raise ValueError(f"EngineConfig.{name} entries must be ints >= 1, "
                             f"got {t!r}")
    if len(set(t)) != len(t):
        raise ValueError(f"EngineConfig.{name} has duplicate buckets: {t!r}")


def chunk_plan(prompt_len: int, chunks: Sequence[int]) -> Tuple[int, ...]:
    """Greedy largest-first exact decomposition of a padded prompt bucket
    into chunk sizes; raises when the sizes cannot cover it exactly."""
    out = []
    rem = int(prompt_len)
    for c in sorted(chunks, reverse=True):
        while rem >= c:
            out.append(int(c))
            rem -= c
    if rem:
        raise ValueError(f"chunk buckets {tuple(sorted(chunks))} cannot "
                         f"exactly cover prompt bucket {prompt_len} "
                         f"(greedy remainder {rem})")
    return tuple(out)


def bucket_up(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; raises if the request doesn't fit any bucket."""
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    raise ValueError(f"no bucket >= {n} in {tuple(sorted(buckets))}")


def bucket_for(prompt_len: int, new_tokens: int, cfg: EngineConfig,
               batch: int) -> BucketSpec:
    """Map a request shape to its step bucket at the given wave width."""
    if prompt_len < 1 or new_tokens < 1:
        raise ValueError(f"need prompt_len>=1, new_tokens>=1, got "
                         f"({prompt_len}, {new_tokens})")
    p = bucket_up(prompt_len, cfg.prompt_buckets)
    n = bucket_up(new_tokens, cfg.new_token_buckets)
    return BucketSpec(batch=batch, prompt_len=p, total_len=p + n)


def pad_prompts(prompts: Sequence[Sequence[int]], bucket: BucketSpec,
                pad_token: int) -> np.ndarray:
    """Right-pad prompts to the bucket prompt length and the batch with
    all-pad dummy rows; returns (bucket.batch, bucket.prompt_len) int32."""
    if len(prompts) > bucket.batch:
        raise ValueError(f"{len(prompts)} prompts > bucket batch {bucket.batch}")
    out = np.full((bucket.batch, bucket.prompt_len), pad_token, np.int32)
    for i, p in enumerate(prompts):
        p = np.asarray(p, np.int32)
        if p.ndim != 1 or p.shape[0] > bucket.prompt_len:
            raise ValueError(f"prompt {i} shape {p.shape} does not fit "
                             f"bucket prompt_len {bucket.prompt_len}")
        out[i, :p.shape[0]] = p
    return out
