"""One validated configuration namespace for the whole pipeline (port of
`repro.pipeline.config`).

Every section and field is the JAX package's, so a plan's embedded config
parses here under the same strictness (unknown keys rejected, tuples
restored by field type) and a config written here parses there.
`ScheduleConfig` and `SelectionConfig` are plain copies of the JAX package's
dataclasses, read by the port's `repro_torch.core.schedule` and
`repro_torch.core.weight_selection`. `reduced_cnn_config` and
`reduced_lm_config` are the JAX package's CPU-smoke presets.
"""

from __future__ import annotations

import dataclasses
import json
import re
import typing
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.qat import K_MAX

CNN_ARCHS = ("lenet5", "resnet8", "resnet20", "resnet50")
SEARCH_MODES = ("serial", "batched")


@dataclasses.dataclass
class ScheduleConfig:
    """Copy of `repro.core.schedule.ScheduleConfig`."""

    prune_ratios: Tuple[float, ...] = (0.7, 0.5, 0.3)
    k_targets: Tuple[int, ...] = (16, 24, 32)
    msr_bits: Tuple[int, ...] = (0,)
    delta_acc: float = 0.03
    finetune_steps: int = 60
    trial_finetune_steps: int = 30
    eval_batches: int = 4
    min_energy_share: float = 0.01
    max_layers: Optional[int] = None
    search_mode: str = "batched"
    msr_energy_prior: bool = True


@dataclasses.dataclass
class SelectionConfig:
    """Copy of `repro.core.weight_selection.SelectionConfig`."""

    k_init: int = 32
    k_target: int = 16
    delta_acc: float = 0.03
    epsilon: float = 1e-3
    usage_weight: float = 0.5
    score_batches: int = 1
    accept_batches: int = 4
    max_score_candidates: int = 32


@dataclasses.dataclass
class TargetConfig:
    """What model the pipeline compresses and how its runtime is built."""

    kind: str = "cnn"            # "cnn" | "lm" | "moe" | "scan"
    arch: str = "lenet5"         # cnn: CNN_ARCHS
    reduced: bool = False        # lm: scaled_down CPU config of the family
    seed: int = 0                # param init seed
    data_seed: int = 7           # synthetic dataset seed (cnn)
    batch_size: int = 64         # train/eval batch (cnn)
    lr: float = 2e-3             # QAT learning rate (cnn)
    ckpt_dir: Optional[str] = None  # lm: restore params instead of init


@dataclasses.dataclass
class TrainStageConfig:
    """QAT base training before profiling + the post-schedule fine-tune."""

    qat_steps: int = 300
    final_finetune_steps: int = 100
    eval_batches: int = 4


@dataclasses.dataclass
class ProfileStageConfig:
    """Systolic-trace profiling budget."""

    batches: int = 1
    max_tiles: int = 16
    verify_cosim: bool = False


@dataclasses.dataclass
class RoutingStageConfig:
    """Routing/activity calibration for the moe/scan targets: the
    calibration prefills' batches (drawn from ``np.random.default_rng``
    seeded by ``calib_seed``; the JAX package seeds a ``jax.random`` chain)
    and the ladder of codebook sizes routed units are ranked onto."""

    calib_batches: int = 2
    calib_batch_size: int = 2
    calib_seq_len: int = 32
    calib_seed: int = 0
    k_ladder: Tuple[int, ...] = (4, 8, 16)


@dataclasses.dataclass
class ExportStageConfig:
    """Packed 4-bit artifact export (see repro_torch.core.export)."""

    block_k: int = 128


@dataclasses.dataclass
class ServeStageConfig:
    """Serve-stage behaviour. The CNN target reads ``use_ref_kernel`` only so
    plans cross-load; it selects nothing here (see `QuantConfig`)."""

    mode: str = "engine"
    compress_k: int = 0
    plans: Tuple[str, ...] = ()
    plans_dir: Optional[str] = None
    requests: int = 4
    prompt_len: int = 32
    new_tokens: int = 16
    mixed: bool = False
    mixed_stride: int = 7
    max_batch: int = 8
    temperature: float = 0.0
    prompt_seed: int = 100
    verify_oneshot: bool = False
    use_ref_kernel: bool = False


@dataclasses.dataclass
class PipelineConfig:
    target: TargetConfig = dataclasses.field(default_factory=TargetConfig)
    train: TrainStageConfig = dataclasses.field(
        default_factory=TrainStageConfig)
    profile: ProfileStageConfig = dataclasses.field(
        default_factory=ProfileStageConfig)
    schedule: ScheduleConfig = dataclasses.field(
        default_factory=ScheduleConfig)
    selection: SelectionConfig = dataclasses.field(
        default_factory=SelectionConfig)
    routing: RoutingStageConfig = dataclasses.field(
        default_factory=RoutingStageConfig)
    export: ExportStageConfig = dataclasses.field(
        default_factory=ExportStageConfig)
    serve: ServeStageConfig = dataclasses.field(
        default_factory=ServeStageConfig)

    # ------------------------------------------------------------ round-trip

    def to_dict(self) -> Dict[str, Any]:
        return _asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineConfig":
        cfg = _build(cls, d, path="config")
        cfg.validate()
        return cfg

    @classmethod
    def load(cls, path) -> "PipelineConfig":
        """Read a config JSON file (either package's)."""
        return cls.from_dict(json.loads(Path(path).read_text()))

    # ------------------------------------------------------------ validation

    def validate(self) -> "PipelineConfig":
        t = self.target
        if t.kind not in ("cnn", "lm", "moe", "scan"):
            raise ValueError(f"target.kind must be one of 'cnn', 'lm', "
                             f"'moe', 'scan', got {t.kind!r}")
        if t.kind == "cnn" and t.arch not in CNN_ARCHS:
            raise ValueError(
                f"target.arch {t.arch!r} is not a CNN arch {CNN_ARCHS}")
        if self.schedule.search_mode not in SEARCH_MODES:
            raise ValueError(
                f"schedule.search_mode must be one of "
                f"{sorted(SEARCH_MODES)}, got {self.schedule.search_mode!r}")
        for p in self.schedule.prune_ratios:
            if not 0.0 <= p < 1.0:
                raise ValueError(f"schedule.prune_ratios entry {p} not in [0, 1)")
        for k in self.schedule.k_targets:
            if not 1 <= k <= K_MAX:
                raise ValueError(f"schedule.k_targets entry {k} not in [1, {K_MAX}]")
        for m in self.schedule.msr_bits:
            if not 0 <= m <= 8:
                raise ValueError(
                    f"schedule.msr_bits entry {m} not in [0, 8] "
                    f"(0 disables MSR truncation; int8 weights have at "
                    f"most 8 magnitude bits)")
        if not 1 <= self.selection.k_target <= self.selection.k_init <= 256:
            raise ValueError(
                f"selection needs 1 <= k_target <= k_init, got "
                f"{self.selection.k_target} / {self.selection.k_init}")
        if self.serve.mode not in ("engine", "oneshot"):
            raise ValueError(
                f"serve.mode must be 'engine' or 'oneshot', got {self.serve.mode!r}")
        if not 0 <= self.serve.compress_k <= K_MAX:
            raise ValueError(
                f"serve.compress_k must be in [0, {K_MAX}], got "
                f"{self.serve.compress_k}")
        if (self.serve.plans or self.serve.plans_dir) \
                and self.target.kind == "cnn":
            raise ValueError("serve.plans / serve.plans_dir (fleet serving) "
                             "need an LM-family target")
        if not self.routing.k_ladder:
            raise ValueError("routing.k_ladder must not be empty")
        for k in self.routing.k_ladder:
            if not 1 <= k <= K_MAX:
                raise ValueError(
                    f"routing.k_ladder entry {k} not in [1, {K_MAX}]")
        for name in ("calib_batches", "calib_batch_size", "calib_seq_len"):
            if getattr(self.routing, name) < 1:
                raise ValueError(f"routing.{name} must be >= 1")
        for spec in self.serve.plans:
            k, msr = parse_plan_spec(spec)
            if k is None:
                continue  # a saved-plan path; existence checked at load
            if not 0 <= k <= K_MAX:
                raise ValueError(
                    f"serve.plans entry {spec!r}: k must be in [0, {K_MAX}]")
            if not 0 <= msr <= 8:
                raise ValueError(
                    f"serve.plans entry {spec!r}: msr bits must be in [0, 8]")
        for name in ("qat_steps", "final_finetune_steps", "eval_batches"):
            if getattr(self.train, name) < 0:
                raise ValueError(f"train.{name} must be >= 0")
        return self

    # ------------------------------------------------------------- overrides

    def with_overrides(
        self, overrides: Optional[Dict[str, Dict[str, Any]]]
    ) -> "PipelineConfig":
        """Functional per-section overrides: ``{"serve": {"mode": ...}}``.
        Unknown sections or fields raise (same strictness as `from_dict`)."""
        if not overrides:
            return self
        sections = {f.name: f for f in dataclasses.fields(self)}
        out = self
        for section, fields in overrides.items():
            if section not in sections:
                raise ValueError(
                    f"unknown config section {section!r}; have "
                    f"{sorted(sections)}")
            cur = getattr(out, section)
            valid = {f.name for f in dataclasses.fields(cur)}
            bad = set(fields) - valid
            if bad:
                raise ValueError(
                    f"unknown field(s) {sorted(bad)} for section {section!r}")
            out = dataclasses.replace(
                out, **{section: dataclasses.replace(cur, **fields)})
        out.validate()
        return out


def reduced_cnn_config(**target_kw) -> PipelineConfig:
    """CPU-smoke preset: a LeNet-5 micro-run of the full pipeline (port of
    `repro.pipeline.config.reduced_cnn_config`; what ``compress --reduced``
    runs). Its ``schedule.search_mode`` is the default, ``"batched"``, as in
    the JAX package."""
    target = TargetConfig(kind="cnn", arch="lenet5", data_seed=5,
                          batch_size=64, lr=2e-3, **target_kw)
    return PipelineConfig(
        target=target,
        train=TrainStageConfig(qat_steps=60, final_finetune_steps=15,
                               eval_batches=2),
        profile=ProfileStageConfig(batches=1, max_tiles=4),
        schedule=ScheduleConfig(prune_ratios=(0.5,), k_targets=(16,),
                                delta_acc=0.08, finetune_steps=10,
                                trial_finetune_steps=8, eval_batches=1,
                                max_layers=1),
        selection=SelectionConfig(k_init=20, k_target=16, delta_acc=0.08,
                                  score_batches=1, accept_batches=1,
                                  max_score_candidates=3),
    )


def reduced_lm_config(arch: str = "olmo-1b", *, compress_k: int = 4,
                      **serve_kw) -> PipelineConfig:
    """CPU-smoke preset for an LM target (port of
    `repro.pipeline.config.reduced_lm_config`): the family's scaled-down
    config, no LM QAT steps, a uniform ``compress_k``-value restriction,
    and the JAX preset's serve fields (read by `LMTarget.stage_serve`)."""
    serve = ServeStageConfig(compress_k=compress_k, requests=2, prompt_len=12,
                             new_tokens=6, mixed=True, max_batch=4)
    serve = dataclasses.replace(serve, **serve_kw)
    return PipelineConfig(
        target=TargetConfig(kind="lm", arch=arch, reduced=True),
        train=TrainStageConfig(qat_steps=0, final_finetune_steps=0),
        serve=serve,
    )


def reduced_moe_config(arch: str = "phi3.5-moe-42b-a6.6b", *,
                       compress_k: int = 4, **serve_kw) -> PipelineConfig:
    """CPU-smoke preset for a routed MoE target (port of
    `repro.pipeline.config.reduced_moe_config`): `reduced_lm_config` with
    ``kind="moe"``, a uniform codebook floor plus per-expert k sized by
    measured dispatch traffic."""
    cfg = reduced_lm_config(arch, compress_k=compress_k, **serve_kw)
    return dataclasses.replace(
        cfg, target=dataclasses.replace(cfg.target, kind="moe"))


def reduced_scan_config(arch: str = "mamba2-1.3b", *, compress_k: int = 4,
                        **serve_kw) -> PipelineConfig:
    """CPU-smoke preset for a routed SSM / RG-LRU target (port of
    `repro.pipeline.config.reduced_scan_config`): per-scan-unit k sized by
    measured activation activity."""
    cfg = reduced_lm_config(arch, compress_k=compress_k, **serve_kw)
    return dataclasses.replace(
        cfg, target=dataclasses.replace(cfg.target, kind="scan"))


def parse_plan_spec(spec: str) -> Tuple[Optional[int], int]:
    """Parse a fleet plan shorthand: ``"base"`` -> (0, 0), ``"k4"`` ->
    (4, 0), ``"k8m2"`` -> (8, 2). Anything else is a saved-plan path and
    returns (None, 0)."""
    if spec == "base":
        return 0, 0
    m = re.fullmatch(r"k(\d+)(?:m(\d+))?", spec)
    if m:
        return int(m.group(1)), int(m.group(2) or 0)
    return None, 0


# ----------------------------------------------------- dict <-> dataclasses


def _asdict(obj) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _asdict(v) for k, v in obj.items()}
    return obj


def _build(dc_cls, d: Dict[str, Any], *, path: str):
    if not isinstance(d, dict):
        raise ValueError(f"{path}: expected a dict for {dc_cls.__name__}, "
                         f"got {type(d).__name__}")
    fields = {f.name: f for f in dataclasses.fields(dc_cls)}
    unknown = set(d) - set(fields)
    if unknown:
        raise ValueError(f"{path}: unknown field(s) {sorted(unknown)} for "
                         f"{dc_cls.__name__}")
    hints = typing.get_type_hints(dc_cls)
    kwargs = {name: _coerce(hints.get(name, Any), value,
                            path=f"{path}.{name}")
              for name, value in d.items()}
    return dc_cls(**kwargs)


def _coerce(hint, value, *, path: str):
    origin = typing.get_origin(hint)
    if dataclasses.is_dataclass(hint) and isinstance(hint, type):
        return _build(hint, value, path=path)
    if origin in (tuple, Tuple) and isinstance(value, (list, tuple)):
        args = typing.get_args(hint)
        inner = args[0] if args else Any
        return tuple(_coerce(inner, v, path=path) for v in value)
    if origin is typing.Union:  # Optional[...]
        if value is None:
            return None
        for arg in typing.get_args(hint):
            if arg is type(None):
                continue
            return _coerce(arg, value, path=path)
    return value
