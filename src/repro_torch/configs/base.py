"""Shape registry + --arch config lookup.

The four assigned input shapes (same set for every LM arch):

  train_4k     seq=4096,   global_batch=256   -> lowers train_step
  prefill_32k  seq=32768,  global_batch=32    -> lowers prefill_step
  decode_32k   seq=32768,  global_batch=128   -> lowers serve_step (1 new
                                                token, KV cache of seq len)
  long_500k    seq=524288, global_batch=1     -> serve_step; requires
                                                sub-quadratic sequence mixing
                                                (SSM / hybrid only — see
                                                DESIGN.md for the 8 skips)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}

ALL_ARCHS = [
    "internvl2-26b",
    "recurrentgemma-2b",
    "gemma3-4b",
    "olmo-1b",
    "phi3-mini-3.8b",
    "qwen2.5-14b",
    "whisper-large-v3",
    "phi3.5-moe-42b-a6.6b",
    "moonshot-v1-16b-a3b",
    "mamba2-1.3b",
    # the paper's own CNNs are configured by repro_torch.nn.cnn's factories
]

_MODULE_OF = {name: name.replace("-", "_").replace(".", "_") for name in ALL_ARCHS}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULE_OF:
        raise KeyError(f"unknown arch {name!r}; choose from {ALL_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[name]}")
    return mod.CONFIG


# long-context decode needs a bounded cache: SSM state or recurrent state +
# windowed local attention. Pure full-attention archs keep a full 500k KV and
# are skipped per the assignment (documented in DESIGN.md).
_LONG_OK_FAMILIES = {"ssm", "hybrid"}


def cell_is_runnable(arch: str, shape: str) -> bool:
    cfg = get_config(arch)
    if shape == "long_500k":
        return cfg.family in _LONG_OK_FAMILIES
    return True


def skip_reason(arch: str, shape: str) -> Optional[str]:
    if cell_is_runnable(arch, shape):
        return None
    return ("full-attention KV cache at 500k context (global layers keep the "
            "entire KV); long_500k runs only for SSM/hybrid archs per the "
            "assignment")
