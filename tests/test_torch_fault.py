"""The port's resilient training loop, straggler monitor, heartbeats and
gradient compressors (`repro_torch.distributed.fault`,
`repro_torch.optim.compression`) against the JAX package's, on the same
numpy data.

Tolerances and why:
  * the loop's report (steps run, failures, restores, final step,
    stragglers): equal; its losses rtol 1e-6 and the final parameters
    allclose at 1e-6 against JAX's (float32 SGD on a quadratic, the same
    operations; only XLA's and PyTorch's reduction orders may differ);
  * the port's faulty run against its own fault-free run: bit for bit (a
    restore reads back the bytes a save wrote, and the data is a pure
    function of the step);
  * the straggler monitor and the heartbeats: equal (host arithmetic);
  * the compressors' dequantized gradients, error-feedback state and stats
    against JAX's over three steps: equal (one float32 division by the
    float32 scale, round half to even, a clip and one product, in the same
    order; the top-k threshold is the k-th largest magnitude in both);
  * error-feedback convergence: atol 1e-2, the JAX test's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.distributed.fault import Heartbeat as JHeartbeat
from repro.distributed.fault import StragglerMonitor as JStragglerMonitor
from repro.distributed.fault import run_resilient_loop as j_run_loop
from repro.optim import compression as jcomp
from repro.optim.optimizers import adamw as j_adamw
from repro.optim.optimizers import apply_updates as j_apply
from repro.optim.optimizers import sgdm as j_sgdm
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.fault import (
    Heartbeat,
    LoopReport,
    StragglerMonitor,
    run_resilient_loop,
)
from repro_torch.optim import compression as tcomp
from repro_torch.optim.optimizers import adamw, apply_updates, sgdm

FAULTS = {3, 13, 22}
N_STEPS, EVERY = 25, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work in this file runs on one thread: beside the
    suite's parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(step):
    """The step's batch as numpy: a pure function of the step."""
    return np.random.default_rng([17, step]).standard_normal(4).astype(
        np.float32)


def _hook(faults):
    fired = set()

    def hook(step):
        if step in faults and step not in fired:
            fired.add(step)
            raise RuntimeError(f"injected device failure at step {step}")

    return hook


def _port_loop(faults, path, monitor=None):
    opt = sgdm(0.05)

    def step_fn(state, batch):
        w = state["params"]["w"]
        g = {"w": 2.0 * (w - batch)}
        updates, o = opt.update(g, state["opt"], state["params"])
        return ({"params": apply_updates(state["params"], updates),
                 "opt": o},
                {"loss": torch.sum((w - batch) ** 2)})

    params = {"w": torch.zeros(4)}
    state = {"params": params, "opt": opt.init(params)}
    return run_resilient_loop(
        step_fn=step_fn, data_fn=lambda s: torch.from_numpy(_data(s)),
        state=state, ckpt=CheckpointManager(path, async_save=False),
        n_steps=N_STEPS, checkpoint_every=EVERY, fault_hook=_hook(faults),
        monitor=monitor, device="cpu")


def _jax_loop(faults, path):
    opt = j_sgdm(0.05)

    def step_fn(state, batch):
        loss, g = jax.value_and_grad(
            lambda p: jnp.sum((p["w"] - batch) ** 2))(state["params"])
        updates, o = opt.update(g, state["opt"], state["params"])
        return ({"params": j_apply(state["params"], updates), "opt": o},
                {"loss": loss})

    params = {"w": jnp.zeros((4,))}
    state = {"params": params, "opt": opt.init(params)}
    return j_run_loop(
        step_fn=step_fn, data_fn=lambda s: jnp.asarray(_data(s)),
        state=state, ckpt=JCheckpointManager(path, async_save=False),
        n_steps=N_STEPS, checkpoint_every=EVERY, fault_hook=_hook(faults))


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loops")
    return {"clean": _port_loop(set(), tmp / "clean"),
            "faulty": _port_loop(FAULTS, tmp / "faulty"),
            "jax": _jax_loop(FAULTS, tmp / "jax"), "dir": tmp}


def _fields(report):
    return {f: getattr(report, f) for f in ("steps_run", "failures",
                                            "restores", "final_step",
                                            "stragglers")}


def test_resilient_loop_report_matches_jax(loops):
    (_, report), (_, jreport) = loops["faulty"], loops["jax"]
    assert isinstance(report, LoopReport)
    assert _fields(report) == _fields(jreport)
    assert report.failures == report.restores == len(FAULTS)
    assert report.final_step == N_STEPS
    assert report.steps_run == N_STEPS + 8      # 3 + 3 + 2 steps replayed
    np.testing.assert_allclose(report.losses, jreport.losses, rtol=1e-6)


def test_resilient_loop_final_params_match_jax(loops):
    (state, _), (jstate, _) = loops["faulty"], loops["jax"]
    np.testing.assert_allclose(state["params"]["w"].numpy(),
                               np.asarray(jstate["params"]["w"]), atol=1e-6)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == N_STEPS


def test_faulty_run_equals_fault_free_run_bit_for_bit(loops):
    (clean, crep), (faulty, frep) = loops["clean"], loops["faulty"]
    assert crep.failures == 0 and crep.steps_run == N_STEPS
    # the restored tree keeps the caller's structure and key order
    assert list(faulty) == ["params", "opt"]
    assert list(faulty["opt"]) == list(clean["opt"])
    for a, b in ((clean["params"]["w"], faulty["params"]["w"]),
                 (clean["opt"]["vel"]["w"], faulty["opt"]["vel"]["w"]),
                 (clean["opt"]["step"], faulty["opt"]["step"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the loop's last, blocking save holds the final state
    step, saved = CheckpointManager(loops["dir"] / "faulty").restore(
        device="cpu")
    assert step == N_STEPS
    assert torch.equal(saved["params"]["w"], faulty["params"]["w"])


def test_loop_gives_up_after_max_restores(tmp_path):
    opt = sgdm(0.1)
    params = {"w": torch.zeros(2)}

    def always(step):
        raise RuntimeError("the device is gone")

    with pytest.raises(RuntimeError, match="gone"):
        run_resilient_loop(
            step_fn=lambda s, b: (s, {}), data_fn=lambda s: None,
            state={"params": params, "opt": opt.init(params)},
            ckpt=CheckpointManager(tmp_path, async_save=False), n_steps=3,
            max_restores=2, fault_hook=always, device="cpu")


def test_loop_restores_from_an_existing_checkpoint(tmp_path):
    """A loop resumed over a directory that already holds checkpoints does
    not save its start again, and restores the latest one on a fault."""
    _port_loop(set(), tmp_path)
    ckpt = CheckpointManager(tmp_path, async_save=False)
    assert ckpt.latest_step() == N_STEPS
    calls = []

    def step_fn(state, batch):
        calls.append(batch)
        return state, {}

    opt = sgdm(0.05)
    params = {"w": torch.full((4,), 7.0)}
    out, rep = run_resilient_loop(
        step_fn=step_fn, data_fn=lambda s: s,
        state={"params": params, "opt": opt.init(params)},
        ckpt=CheckpointManager(tmp_path, async_save=False), n_steps=2,
        start_step=N_STEPS, fault_hook=_hook({N_STEPS}), device="cpu")
    assert rep.failures == rep.restores == 1
    assert rep.final_step == N_STEPS + 2 and calls == [N_STEPS, N_STEPS + 1]
    # the fault restored the earlier run's last checkpoint over the 7s
    _, saved = ckpt.restore(N_STEPS, device="cpu")
    assert torch.equal(out["params"]["w"], saved["params"]["w"])


# ------------------------------------------------- stragglers, heartbeats


def test_straggler_monitor_matches_jax():
    rng = np.random.default_rng(3)
    times = list(0.1 + 0.01 * rng.random(40))
    times[12], times[25], times[33] = 0.6, 0.3, 0.2   # 0.2: under 2 x
    port = StragglerMonitor(window=16, threshold=2.0)
    ref = JStragglerMonitor(window=16, threshold=2.0)
    seen = []
    port.on_straggler = lambda step, s, med: seen.append((step, s, med))
    got = [port.record(i, t) for i, t in enumerate(times)]
    want = [ref.record(i, t) for i, t in enumerate(times)]
    assert got == want and port.flagged == ref.flagged
    assert port.flagged == [12, 25] and [s for s, _, _ in seen] == [12, 25]
    # the JAX test's sequence
    mon = StragglerMonitor(window=16, threshold=2.0)
    for i in range(20):
        mon.record(i, 0.1)
    assert mon.record(20, 0.5) is True and 20 in mon.flagged
    assert mon.record(21, 0.11) is False


def test_heartbeat_matches_jax():
    port, ref = Heartbeat(timeout=10.0), JHeartbeat(timeout=10.0)
    for hb in (port, ref):
        hb.beat(0, now=100.0)
        hb.beat(1, now=100.0)
        hb.beat(2, now=104.0)
        hb.beat(0, now=120.0)
    for now in (105.0, 112.0, 115.0, 125.0, 131.0):
        assert port.dead_workers(now=now) == ref.dead_workers(now=now)
    assert port.dead_workers(now=125.0) == [1, 2]
    assert Heartbeat().dead_workers() == []


# ------------------------------------------------------------ compression


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((16, 8)) * 0.3).astype(np.float32),
            "b": {"x": (rng.standard_normal(8) * 1e-3).astype(np.float32),
                  "z": np.zeros(5, np.float32)}}


def _as_np(tree):
    if isinstance(tree, dict):
        return {k: _as_np(v) for k, v in tree.items()}
    return np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                      else tree)


def _assert_same(a, b):
    a, b = _as_np(a), _as_np(jax.device_get(b))
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name,make", [
    ("int8", lambda m: m.int8_compressor()),
    ("topk", lambda m: m.topk_compressor(0.1)),
    ("topk_one", lambda m: m.topk_compressor(0.001))])
def test_compressors_match_jax(name, make):
    port, ref = make(tcomp), make(jcomp)
    g0 = _grads(0)
    ef = port.init({k: v for k, v in
                    jax.tree.map(torch.from_numpy, g0).items()})
    jef = ref.init(jax.tree.map(jnp.asarray, g0))
    _assert_same(ef, jef)
    for step in range(3):
        g = _grads(step)
        out, ef, stats = port.compress(jax.tree.map(torch.from_numpy, g), ef)
        jout, jef, jstats = ref.compress(jax.tree.map(jnp.asarray, g), jef)
        _assert_same(out, jout)
        _assert_same(ef, jef)
        assert stats == jstats
    assert stats["wire_bytes"] < stats["raw_bytes"]


def test_int8_codes_round_half_to_even_by_a_tensor_scale():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -126.5])
    q, scale, _ = tcomp.int8_codes(g, torch.zeros_like(g))
    assert scale.dtype == torch.float32 and scale.ndim == 0
    assert q.dtype == torch.int8
    assert q.tolist() == [127, 0, 2, 2, 0, -126]


@pytest.mark.parametrize("name,make", [
    ("int8", lambda m: m.int8_compressor()),
    ("topk", lambda m: m.topk_compressor(0.05))])
def test_gradient_compression_error_feedback_converges(name, make):
    """Compressed SGD on a quadratic still reaches the optimum thanks to
    error feedback (the JAX test's case), in step with JAX's."""
    target = np.asarray([1.0, -2.0, 3.0, 0.5], np.float32)
    params = {"w": torch.zeros(4)}
    jparams = {"w": jnp.zeros((4,))}
    opt = tcomp.compressed(sgdm(0.2, momentum=0.0), make(tcomp))
    jopt = jcomp.compressed(j_sgdm(0.2, momentum=0.0), make(jcomp))
    state, jstate = opt.init(params), jopt.init(jparams)
    tt = torch.from_numpy(target)
    for _ in range(200):
        g = {"w": 2.0 * (params["w"] - tt)}
        updates, state = opt.update(g, state, params)
        params = apply_updates(params, updates)
        jg = jax.grad(lambda p: jnp.sum((p["w"] - target) ** 2))(jparams)
        jupdates, jstate = jopt.update(jg, jstate, jparams)
        jparams = j_apply(jparams, jupdates)
    np.testing.assert_allclose(params["w"].numpy(), target, atol=1e-2)
    np.testing.assert_allclose(params["w"].numpy(),
                               np.asarray(jparams["w"]), atol=1e-6)


def test_compressed_adamw_matches_jax():
    """AdamW wrapped in the int8 compressor, 5 steps on the same gradients:
    the updates and the wrapped state against JAX's (rel 1e-6, the
    optimizer tests' bound: the global norm sums in another order)."""
    g0 = _grads(0)
    params = jax.tree.map(torch.from_numpy, g0)
    jparams = jax.tree.map(jnp.asarray, g0)
    opt = tcomp.compressed(adamw(1e-2), tcomp.int8_compressor())
    jopt = jcomp.compressed(j_adamw(1e-2), jcomp.int8_compressor())
    state, jstate = opt.init(params), jopt.init(jparams)
    assert set(state) == set(jstate) == {"inner", "ef"}
    for step in range(5):
        g = _grads(10 + step)
        updates, state = opt.update(jax.tree.map(torch.from_numpy, g),
                                    state, params)
        jupdates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                       jparams)
        params, jparams = apply_updates(params, updates), j_apply(jparams,
                                                                  jupdates)
    for got, want in ((params, jparams), (state["ef"], jstate["ef"])):
        for a, b in zip(jax.tree.leaves(_as_np(got)),
                        jax.tree.leaves(jax.device_get(want))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
