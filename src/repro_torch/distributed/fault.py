"""Fault tolerance: resilient training loop, straggler detection, heartbeats
(port of `repro.distributed.fault`).

`run_resilient_loop` is the production loop's shape: a step function, a
deterministic step-indexed data source, a `CheckpointManager`, and a fault
policy. On any step failure (a lost device shows up as an exception from
the runtime) the loop restores the last checkpoint and replays; the data
being a pure function of the step index makes the replay bit-identical.
Fault injection hooks let tests exercise the recovery path.

`StragglerMonitor` tracks per-step wall times against a rolling median and
flags outliers; `Heartbeat` records per logical worker when it was last
seen, so a coordinator can tell slow from dead. Resuming on another mesh
after a lost card is `repro_torch.distributed.elastic.elastic_restore`.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional

from repro_torch._device import DEFAULT_DEVICE, tree_map
from repro_torch.nn.spec import flatten_with_names

if TYPE_CHECKING:
    from repro_torch.checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class StragglerMonitor:
    """Rolling-median step-time outlier detection."""

    window: int = 32
    threshold: float = 2.5          # step > threshold x median => straggler
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    times: List[float] = dataclasses.field(default_factory=list)
    flagged: List[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        recent = self.times[-self.window:]
        if len(recent) >= 8:
            med = statistics.median(recent)
            if seconds > self.threshold * med:
                self.flagged.append(step)
                if self.on_straggler:
                    self.on_straggler(step, seconds, med)
                return True
        return False


@dataclasses.dataclass
class Heartbeat:
    """Per-worker liveness registry (single-host simulation of the
    coordinator-side bookkeeping)."""

    timeout: float = 60.0
    last_seen: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, worker: int, now: Optional[float] = None) -> None:
        self.last_seen[worker] = now if now is not None else time.time()

    def dead_workers(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        return [w for w, t in self.last_seen.items() if now - t > self.timeout]


@dataclasses.dataclass
class LoopReport:
    steps_run: int
    failures: int
    restores: int
    final_step: int
    losses: List[float]
    stragglers: List[int]


def _like(template, restored):
    """``restored`` (a checkpoint's nested dicts) in the structure of
    ``template``: same containers, same key order, leaves matched by their
    `flatten_with_names` path."""
    flat = flatten_with_names(restored)

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        return flat[prefix[:-1]]

    return build(template, "")


def run_resilient_loop(
    *,
    step_fn: Callable,                 # (state, batch) -> (state, metrics)
    data_fn: Callable[[int], Any],     # step -> batch (pure, deterministic)
    state: Any,
    ckpt: "CheckpointManager",
    n_steps: int,
    start_step: int = 0,
    checkpoint_every: int = 50,
    max_restores: int = 10,
    fault_hook: Optional[Callable[[int], None]] = None,  # raise to inject
    monitor: Optional[StragglerMonitor] = None,
    device=DEFAULT_DEVICE,
) -> tuple[Any, LoopReport]:
    """Run with checkpoint/restart semantics. Restores after any exception
    in step_fn (or the injected fault) and replays from the last snapshot.

    ``state`` is a nested dict / list / tuple of tensors; a restore puts
    its leaves on ``device`` (``"cuda"`` unless the caller asks for
    ``"cpu"``) in ``state``'s structure. A loss in the step's metrics is
    read back to the host every step, as in the JAX package."""
    step = start_step
    failures = restores = ran = 0
    losses: List[float] = []
    template = tree_map(lambda _: None, state)   # the structure alone
    if ckpt.latest_step() is None:
        ckpt.save(step, state, block=True)

    while step < start_step + n_steps:
        try:
            if fault_hook is not None:
                fault_hook(step)
            t0 = time.time()
            batch = data_fn(step)
            state, metrics = step_fn(state, batch)
            dt = time.time() - t0
            if monitor is not None:
                monitor.record(step, dt)
            loss = metrics.get("loss") if isinstance(metrics, dict) else None
            if loss is not None:
                losses.append(float(loss))
            ran += 1
            step += 1
            if step % checkpoint_every == 0:
                ckpt.save(step, state)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:
            failures += 1
            if restores >= max_restores:
                raise
            ckpt.wait()
            restored_step, restored = ckpt.restore(device=device)
            state = _like(template, restored)
            step = restored_step
            restores += 1
    ckpt.save(step, state, block=True)
    report = LoopReport(
        steps_run=ran, failures=failures, restores=restores, final_step=step,
        losses=losses, stragglers=(monitor.flagged if monitor else []))
    return state, report
