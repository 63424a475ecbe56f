"""Roofline-driven configuration autotuner for the LUT GEMM (K2) on the
H100 (port of `repro.kernels.lut_matmul.autotune`).

The kernel's knobs are its configurations (`lut_matmul.K2Config`): a block
tile from the kernel's table (BM 128 / 64 / 32 / 16 by BN 16 / 32 / 64; BM
32 and 16 only for M <= 32) and where the weight is dequantized, in a
pre-pass into a float64 scratch or inside the GEMM a tile at a time. Every
configuration sums each output in the same order, so the choice moves time,
never a bit of the result.

This module scores every legal configuration of an ``(M, K_x, N)`` problem
against a machine-balance model of the card (`MachineBalance`: float64
tensor-core peak, HBM bandwidth, SMs, shared memory, a per-launch cost, the
rate of in-GEMM dequantization) and caches the winner under a content
fingerprint of the problem (`shape_fingerprint`: blake2b, the discipline of
`repro_torch.serving.fleet.comp_fingerprint`). An optional ``measure``
callback times the model's top k on the card and keeps the fastest.

The cache persists as JSON (`BlockAutotuner.save` / ``load``, version 1);
``REPRO_TORCH_LUT_AUTOTUNE_CACHE`` names the path of the process-wide tuner
(`get_default_autotuner`), which `ops.lut_matmul_fused` consults for every
call that passes no configuration. The JAX package's cache names its own
knobs (TPU block shapes) under another variable; the two never mix.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import os
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.kernels.lut_matmul.lut_matmul import (
    DEQUANT,
    KC,
    TILES,
    K2Config,
    default_config,
    tile_dequant_legal,
)

ENV_CACHE_PATH = "REPRO_TORCH_LUT_AUTOTUNE_CACHE"
SMALL_M = 32        # BM 32 and 16 are candidates up to this M


@dataclasses.dataclass(frozen=True)
class MachineBalance:
    """One card's balance (defaults: the H100 SXM; the peaks are the
    constants of the bounds in PERF.md). `from_device` reads the SMs and
    shared memory off a card."""

    f64_flops: float = 67e12        # float64 tensor-core peak (DMMA)
    hbm_bw: float = 3.35e12         # HBM bytes/s
    sms: int = 132
    smem_per_block: int = 227 * 1024   # dynamic shared memory a block may take
    smem_per_sm: int = 228 * 1024
    threads_per_sm: int = 2048
    # weights formed a second inside the GEMM with every warp scheduler
    # busy, and by the pre-pass kernel, and a launch's fixed cost: fitted to
    # every configuration's device time at 31 K2 shapes on an H100 80GB
    # HBM3 (PERF.md), where the model's pick then came within 17% of the
    # fastest configuration at every shape, 2.8% on average
    dequant_rate: float = 3e11
    prepass_rate: float = 5e10
    launch_s: float = 1e-6

    @classmethod
    def from_device(cls, device=0) -> "MachineBalance":
        p = torch.cuda.get_device_properties(device)
        return cls(sms=p.multi_processor_count,
                   smem_per_block=p.shared_memory_per_block_optin,
                   smem_per_sm=p.shared_memory_per_multiprocessor,
                   threads_per_sm=p.max_threads_per_multi_processor)


_BALANCE = MachineBalance()


def _x_bytes(x_dtype) -> int:
    return torch.empty((), dtype=x_dtype).element_size()


def candidate_blocks(m: int, k: int, n: int, x_dtype=torch.float32, *,
                     pack_block: int = 128,
                     balance: MachineBalance = _BALANCE) -> List[K2Config]:
    """The legal configurations of an (M, K_x, N) problem: every tile of the
    kernel's table (BM 32 and 16 only for M <= `SMALL_M`) whose shared
    memory (`K2Config.smem_bytes`, the kernel's ``Tile<...>::kSmem``) fits
    the block budget, with the pre-pass, and with "tile" dequant where it
    takes the problem (`tile_dequant_legal`)."""
    del k
    out = []
    for bm, bn in TILES:
        if bm <= SMALL_M < m:
            continue
        for dq in DEQUANT:
            if dq == "tile" and not tile_dequant_legal(n, pack_block):
                continue
            cfg = K2Config(bm, bn, dq)
            if cfg.smem_bytes(x_dtype) <= balance.smem_per_block:
                out.append(cfg)
    return out


def resident_blocks(cfg: K2Config, x_dtype=torch.float32, *,
                    balance: MachineBalance = _BALANCE) -> int:
    """Blocks of ``cfg`` an SM holds, by shared memory and threads (the
    kernel's registers are not known off the card)."""
    smem = cfg.smem_bytes(x_dtype) + 1024     # + the runtime's reserve
    return max(1, min(balance.smem_per_sm // smem,
                      balance.threads_per_sm // cfg.threads, 32))


def roofline_time(m: int, k: int, n: int, cfg: K2Config,
                  x_dtype=torch.float32, *,
                  balance: MachineBalance = _BALANCE) -> float:
    """Estimated seconds of one call in ``cfg``.

    Traffic: X is read once a tile column; the packed weights once a tile
    row, or (pre-pass) once with the 2 x 8 bytes a weight of the float64
    scratch written and read back; the output once. Operations: float64
    MMAs on the padded work (tiles of BM x BN, K rounded up to the chunk),
    and the dequant of every weight, once (pre-pass) or once a tile row
    (in the GEMM, every chunk of every tile). Tiles run in
    waves over SMs x resident blocks; a wave that leaves the card's warp
    schedulers idle (few tiles, one warp each) runs at that fraction of its
    rate. Each launch (two with the pre-pass) adds a fixed cost."""
    bm, bn = cfg.block_m, cfg.block_n
    kr = math.ceil(max(k, 1) / KC) * KC
    rows, cols = math.ceil(m / bm), math.ceil(n / bn)
    tiles = rows * cols
    warps = cfg.threads // 32
    slots = balance.sms * resident_blocks(cfg, x_dtype, balance=balance)
    if tiles <= slots:
        busy = min(1.0, tiles * warps / (4.0 * balance.sms))
        work = tiles
    else:
        busy = min(1.0, slots * warps / (4.0 * balance.sms))
        work = math.ceil(tiles / slots) * slots
    flops = 2.0 * bm * bn * kr * work
    compute_s = flops / balance.f64_flops / busy
    if cfg.dequant == "tile":   # each warp row of a tile forms its B fragments
        compute_s += (kr * bn * work * (bm // cfg.warp[0])
                      / balance.dequant_rate / busy)
    else:                       # the pre-pass's grid fills the card
        compute_s += kr * cols * bn / balance.prepass_rate

    x_bytes = float(m * k * _x_bytes(x_dtype) * cols)
    packed = kr / 2.0 * cols * bn
    if cfg.dequant == "tile":
        w_bytes = packed * rows
    else:
        w_bytes = 2.0 * 8.0 * kr * cols * bn + packed
    memory_s = (x_bytes + w_bytes + 4.0 * m * n) / balance.hbm_bw
    launches = 1 if cfg.dequant == "tile" else 2
    return max(compute_s, memory_s) + launches * balance.launch_s


@functools.cache
def _cuda_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def device_name(device) -> str:
    """The name a fingerprint carries: ``torch.cuda.get_device_name`` of a
    CUDA device, else the device type (``"cpu"``)."""
    device = torch.device(device)
    if device.type == "cuda":
        return _cuda_name(device.index if device.index is not None
                          else torch.cuda.current_device())
    return device.type


def shape_fingerprint(m: int, k_x: int, k_pad: int, n: int, *,
                      pack_block: int, x_dtype, device: str) -> str:
    """Content fingerprint of one tuning problem: blake2b over
    (``"lut_matmul"``, M, K_x, K_pad, N, the pack block, X's dtype, the
    device name)."""
    payload = repr(("lut_matmul", int(m), int(k_x), int(k_pad), int(n),
                    int(pack_block), str(x_dtype).replace("torch.", ""),
                    str(device)))
    return hashlib.blake2b(payload.encode(), digest_size=8).hexdigest()


class BlockAutotuner:
    """Fingerprint-keyed cache of winning configurations.

    `best` resolves a problem to its cached winner (a *hit*) or runs one
    tuning sweep (a *miss*, which counts a ``retune_events``): rank every
    legal configuration by `roofline_time` (a tie goes to `default_config`),
    optionally time the top k and
    the untuned configuration (`default_config`) through ``measure(config)
    -> seconds``, record the winner. `save` /
    `load` round-trip the cache as JSON, so a warm process never retunes.
    """

    def __init__(self, balance: MachineBalance = _BALANCE, *,
                 path: Optional[str] = None):
        self.balance = balance
        self.path = Path(path) if path else None
        self._cache: Dict[str, dict] = {}
        self._resolved: Dict[tuple, K2Config] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.retune_events = 0
        if self.path is not None and self.path.exists():
            self.load(self.path)

    # ----------------------------------------------------------- resolution

    def best(self, m: int, k_x: int, k_pad: int, n: int, *,
             pack_block: int = 128, x_dtype=torch.float32, device="cpu",
             measure: Optional[Callable[[K2Config], float]] = None,
             top_k: int = 3) -> K2Config:
        """The configuration of an (M, K_x) X against (K_pad / 2, N) packed
        weights on ``device``. A problem seen before costs one dictionary
        lookup under the lock (every K2 call without a configuration comes
        here): the device's name is read only on a miss."""
        key = (m, k_x, k_pad, n, pack_block, x_dtype, device)
        with self._lock:
            cfg = self._resolved.get(key)
            if cfg is not None:
                self.hits += 1
                return cfg
            name = device_name(device)
            fp = shape_fingerprint(m, k_x, k_pad, n, pack_block=pack_block,
                                   x_dtype=x_dtype, device=name)
            entry = self._cache.get(fp)
            if entry is not None:
                self.hits += 1
            else:
                self.misses += 1
                self.retune_events += 1
                entry = self._tune(m, k_x, k_pad, n, pack_block, x_dtype,
                                   name, measure, top_k)
                self._cache[fp] = entry
            cfg = self._resolved[key] = K2Config.from_json(entry["config"])
            return cfg

    def _tune(self, m, k_x, k_pad, n, pack_block, x_dtype, name, measure,
              top_k) -> dict:
        def model(c):
            return roofline_time(m, k_x, n, c, x_dtype, balance=self.balance)

        # a tie in the model keeps the kernel's own choice from N: the model
        # sees no gain there, and the card may see a loss (128x32 and 64x64
        # tiles tie at M = 1024)
        untuned = default_config(n)
        ranked = sorted(candidate_blocks(m, k_x, n, x_dtype,
                                         pack_block=pack_block,
                                         balance=self.balance),
                        key=lambda c: (model(c), c != untuned))
        winner, source, timed = ranked[0], "model", None
        if measure is not None and len(ranked) > 1:
            # the model's top k, and the kernel's own choice from N, so a
            # measured winner is never slower than the untuned call
            timing = ranked[:max(1, top_k)]
            timing += [c for c in (untuned,) if c not in timing]
            timed = {str(c): measure(c) for c in timing}
            winner = min(timing, key=lambda c: timed[str(c)])
            source = "measured"
        return {
            "shape": [int(m), int(k_x), int(k_pad), int(n), int(pack_block)],
            "x_dtype": str(x_dtype).replace("torch.", ""),
            "device": name,
            "config": winner.to_json(),
            "source": source,
            "model_s": model(winner),
            "measured_s": timed,
        }

    def entries(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._cache)

    # ---------------------------------------------------------- persistence

    def save(self, path: Optional[str] = None) -> Path:
        p = Path(path) if path else self.path
        if p is None:
            raise ValueError("no cache path: pass one to save() or __init__")
        p.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            payload = {"version": 1, "entries": self._cache}
        p.write_text(json.dumps(payload, indent=2, sort_keys=True))
        return p

    def load(self, path: Optional[str] = None) -> int:
        """Merge entries from a saved cache; returns how many were loaded."""
        p = Path(path) if path else self.path
        if p is None:
            raise ValueError("no cache path: pass one to load() or __init__")
        payload = json.loads(p.read_text())
        if payload.get("version") != 1:
            raise ValueError(f"unknown autotune cache version in {p}: "
                             f"{payload.get('version')!r}")
        entries = payload["entries"]
        for fp, entry in entries.items():
            if "config" not in entry:
                raise ValueError(
                    f"{p}: entry {fp} names no K2 configuration (a cache of "
                    "the JAX package's tuner names TPU block shapes)")
            K2Config.from_json(entry["config"])      # raises on a bad one
        with self._lock:
            self._cache.update(entries)
            self._resolved.clear()
        return len(entries)

    # -------------------------------------------------------------- reports

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._cache),
                "hits": self.hits,
                "misses": self.misses,
                "retune_events": self.retune_events,
                "path": str(self.path) if self.path else None,
            }

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._resolved.clear()
            self.hits = self.misses = self.retune_events = 0


# the process-wide tuner (`ops.lut_matmul_fused` resolves through it when no
# configuration is passed); honors REPRO_TORCH_LUT_AUTOTUNE_CACHE
_default: Optional[BlockAutotuner] = None
_default_lock = threading.Lock()


def get_default_autotuner() -> BlockAutotuner:
    global _default
    tuner = _default
    if tuner is not None:
        return tuner
    with _default_lock:
        if _default is None:
            _default = BlockAutotuner(path=os.environ.get(ENV_CACHE_PATH))
        return _default


def reset_default_autotuner() -> None:
    """Drop the process-wide tuner (tests; a changed environment path)."""
    global _default
    with _default_lock:
        _default = None
