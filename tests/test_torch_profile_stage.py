"""Port parity for the profile slice as a whole: the energy LUTs, the layer
energy model, and the ``profile`` + ``energy_model`` stage pair against the
JAX package's, plus plans crossing between the packages after
``energy_model``.

The stage pair runs LeNet-5 at batch 2 with ``max_tiles=64``, at least the
50 tiles of its largest layer, so every tile is traced and the tile sampling
(whose draws differ between `jax.random` and `torch.Generator`) drops out.
Both runners read the same numpy batches, and the port starts from the JAX
package's initial parameters.

Tolerances and why:
  * histograms, ``count``, weight-value counts: exact (integers).
  * ``energy_sum`` and the LUTs where ``count > 0``: rtol 1e-4 against the
    JAX package's trace summed tile by tile (`_tilewise_energy`: float32
    within a tile, as the JAX oracle sums, up to 2.4e5 energies per bin,
    2.1e-5 off on LeNet-5's conv1; float64 across tiles). The energy
    shares: rtol 1e-5 against the JAX energy model evaluated on those sums.
    The JAX layer oracle itself sums up to 1.2e7 float32 energies into one
    bin (the zero-weight bin, which holds the tile padding) and drifts by
    up to 1.2e-3 on conv1, so the plan's own ``energy_sum``, LUTs and
    shares are held at rtol 2e-3. The port prices integer event sums once
    in float64.
  * grouped LUT from the same draws: rtol 1e-5 — float32 means over 4096
    draws summed in different orders.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energy_lut as j_lut
from repro.core import qat as jqat
from repro.core import layer_energy as j_le
from repro.core.mac_model import DEFAULT_COEFFS as J_COEFFS
from repro.core.profiler import batched_stats_oracle as j_oracle
from repro.core.profiler import gather_layer_tiles as j_gather
from repro.core.runner import CnnRunner as JRunner
from repro.core.stats import LayerStats as JStats
from repro.core.stats import conv_weight_matrix as j_conv_weight_matrix
from repro.core.stats import pad_to_tiles as j_pad_to_tiles
from repro.nn import cnn as jcnn
from repro.pipeline.config import PipelineConfig as JConfig
from repro.pipeline.pipeline import Pipeline as JPipeline
from repro.pipeline.plan import CompressionPlan as JPlan
from repro.pipeline.schema import validate_plan_doc
from repro.pipeline.targets import CnnTarget as JTarget
from repro_torch.core import energy_lut as t_lut
from repro_torch.core import layer_energy as t_le
from repro_torch.core.runner import CnnRunner as TRunner
from repro_torch.core.stats import LayerStats as TStats
from repro_torch.kernels.transition_energy import transition_energy as tkernel
from repro_torch.nn import cnn as tcnn
from repro_torch.nn.spec import params_from_numpy
from repro_torch.pipeline.config import PipelineConfig as TConfig
from repro_torch.pipeline.pipeline import Pipeline as TPipeline
from repro_torch.pipeline.plan import CompressionPlan as TPlan
from repro_torch.pipeline.targets import CnnTarget as TTarget

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("energy_sum", "count", "group_hist", "act_hist")
_SPLIT = {"train": 0, "val": 1, "test": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work in this file runs on one thread: beside the
    suite's parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def j2t(tree):
    return params_from_numpy(jax.device_get(tree), "cpu")


def _random_stats(seed):
    rng = np.random.default_rng(seed)
    act = rng.integers(0, 50, (256, 256)).astype(np.float32)
    act[:, :100] = 0                          # unseen activation pairs
    grp = rng.integers(0, 500, (50, 50)).astype(np.float32)
    count = rng.integers(0, 9, 256).astype(np.float32) * 63
    energy = (count * rng.uniform(5, 20, 256)).astype(np.float32)
    return dict(act_hist=act, group_hist=grp, energy_sum=energy, count=count,
                n_transitions=int(count.sum()))


# ------------------------------------------------------------ energy LUTs


def test_grouped_lut_from_the_jax_draws_matches_jax():
    s = _random_stats(0)
    jstats = JStats(**{k: (jnp.asarray(v) if k != "n_transitions" else v)
                       for k, v in s.items()})
    n_mc = 4096
    k_a, k_g, k_r1, k_r2 = jax.random.split(jax.random.PRNGKey(1), 4)
    a_idx = jax.random.categorical(
        k_a, jnp.log(jstats.act_hist.reshape(-1) + 1e-20), shape=(n_mc,))
    g_idx = jax.random.categorical(
        k_g, jnp.log(jstats.group_hist.reshape(-1) + 1e-20), shape=(n_mc,))
    reps = j_lut._reps(8)
    r1 = jax.random.randint(k_r1, (n_mc,), 0, reps.shape[1])
    r2 = jax.random.randint(k_r2, (n_mc,), 0, reps.shape[1])
    got = t_lut.grouped_lut_from_draws(
        *(torch.from_numpy(np.array(v)) for v in (a_idx, g_idx, r1, r2,
                                                    reps)))
    want = np.asarray(j_lut.grouped_model_lut(jstats))
    assert got.dtype == torch.float32 and got.shape == (256,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_blended_lut_is_the_trace_where_seen():
    s = _random_stats(1)
    stats = TStats(**{k: (torch.from_numpy(v) if k != "n_transitions" else v)
                      for k, v in s.items()})
    lut = t_lut.blended_lut(stats)
    again = t_lut.blended_lut(stats)
    seen = stats.count > 0
    assert torch.equal(lut, again) and torch.isfinite(lut).all()
    assert torch.equal(lut[seen], stats.trace_lut()[seen])
    jstats = JStats(**{k: (jnp.asarray(v) if k != "n_transitions" else v)
                       for k, v in s.items()})
    np.testing.assert_allclose(stats.trace_lut().numpy(),
                               np.asarray(jstats.trace_lut()), rtol=1e-6)
    fid = t_lut.model_fidelity(stats)
    assert fid["n_seen"] == int(seen.sum()) and -1 <= fid["pearson"] <= 1


# ------------------------------------------------------ layer energy model


@pytest.mark.parametrize("m,k,n", [(20, 70, 300), (64, 128, 64), (6, 75, 9)])
def test_layer_energy_model_matches_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    w = rng.integers(-127, 128, (m, k)).astype(np.int32)
    lut = rng.uniform(1, 30, 256).astype(np.float32)
    jd, td = j_le.MatmulDims(m, k, n), t_le.MatmulDims(m, k, n)
    jc = j_le.weight_value_counts(jnp.asarray(w), jd)
    tc = t_le.weight_value_counts(torch.from_numpy(w), td)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    tl = torch.from_numpy(lut)
    jm = j_le.LayerEnergyModel("l", jd, jnp.asarray(lut), jc)
    tm = t_le.LayerEnergyModel("l", td, tl, tc)
    np.testing.assert_allclose(tm.energy, jm.energy, rtol=1e-6)
    for fn in ("tile_power", "tile_energy"):
        np.testing.assert_allclose(
            float(getattr(t_le, fn)(tc, tl, td)),
            float(getattr(j_le, fn)(jc, jnp.asarray(lut), jd)), rtol=1e-6)
    np.testing.assert_allclose(
        float(t_le.delta_energy_remove(tc, tl, td, int(w[0, 0]), 0)),
        float(j_le.delta_energy_remove(jc, jnp.asarray(lut), jd,
                                       int(w[0, 0]), 0)), rtol=1e-6)
    other = tm.with_counts(tc * 2)
    np.testing.assert_allclose(
        t_le.energy_shares([tm, other]).numpy(),
        np.asarray(j_le.energy_shares([jm, jm.with_counts(jc * 2)])),
        rtol=1e-6)


# ------------------------------------------------------- the stage pair


class _NumpyImages:
    """Seeded numpy batches, handed to both packages' runners."""

    def __init__(self, seed=3):
        self.seed = seed

    def arrays(self, step, batch_size, split):
        rng = np.random.default_rng([self.seed, _SPLIT[split], step])
        x = rng.normal(size=(batch_size, 32, 32, 3)).astype(np.float32)
        return x, rng.integers(0, 10, batch_size)


class _JaxImages(_NumpyImages):
    def batch(self, step, batch_size, split="train"):
        x, y = self.arrays(step, batch_size, split)
        return jnp.asarray(x), jnp.asarray(y, jnp.int32)


class _TorchImages(_NumpyImages):
    def batch(self, step, batch_size, split="train", *, device):
        x, y = self.arrays(step, batch_size, split)
        return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def _tilewise_energy(jrunner, plan):
    """{layer: energy_sum (256,) float64} of the JAX trace of every tile,
    each tile through the JAX oracle on its own and the tiles summed in
    float64."""
    taps = jrunner.capture_taps(plan.params, plan.state, plan.comp, 1)
    out = {}
    for cl in jrunner.model.comp_layers:
        w_pad, x_pad = j_pad_to_tiles(
            *jrunner.layer_trace_inputs(cl, taps[cl.name]))
        total = (w_pad.shape[0] * w_pad.shape[1] * x_pad.shape[1]) // 64 ** 3
        w_t, a_t = j_gather(w_pad, x_pad, jnp.arange(total))
        one = jnp.ones((1,), jnp.float32)
        out[cl.name] = sum(
            np.asarray(j_oracle(w_t[i:i + 1], a_t[i:i + 1], one,
                                J_COEFFS)[0], np.float64)
            for i in range(total))
    return out


def _cfg_dict():
    return {"target": {"arch": "lenet5", "batch_size": 2},
            "train": {"qat_steps": 0, "eval_batches": 2},
            "profile": {"batches": 1, "max_tiles": 64}}


@pytest.fixture(scope="module")
def stage_pair(tmp_path_factory):
    jcfg = JConfig.from_dict(_cfg_dict())
    jrunner = JRunner(jcnn.lenet5(), _JaxImages(), batch_size=2, seed=0)
    jplan = JPipeline(JTarget(jcfg, runner=jrunner), jcfg).run_until(
        "energy_model")

    tcfg = TConfig.from_dict(_cfg_dict())
    trunner = TRunner(tcnn.lenet5(), _TorchImages(), batch_size=2, seed=0,
                      device="cpu")
    start = tuple(j2t(t) for t in (jplan.params, jplan.state,
                                   jplan.opt_state, jplan.comp))
    trunner.init = lambda: start
    pipe = TPipeline(tcfg, device="cpu")
    pipe.target = TTarget(tcfg, torch.device("cpu"), runner=trunner)
    before = tkernel.launches
    tplan = pipe.run_until("energy_model")
    assert tkernel.launches == before            # CPU tensors: plain version

    # the JAX energy model on the tile-wise sums; every weight value a layer
    # holds is in its trace (all tiles traced), so the LUT there is the trace
    energy = _tilewise_energy(jrunner, jplan)
    models = {}
    for cl in jrunner.model.comp_layers:
        s = jplan.stats[cl.name]
        w_int = jqat.quantize_weight_int(
            jrunner.model.get_weight(jplan.params, cl.name),
            jplan.comp[cl.name])
        w_mat = j_conv_weight_matrix(w_int) if cl.kind == "conv" else w_int.T
        lut = JStats(s.act_hist, s.group_hist,
                     jnp.asarray(energy[cl.name], jnp.float32), s.count,
                     s.n_transitions).trace_lut()
        dims = cl.matmul_dims(1)
        models[cl.name] = j_le.LayerEnergyModel(
            cl.name, dims, lut, j_le.weight_value_counts(w_mat, dims))
    e_total = sum(m.energy for m in models.values())
    return dict(jax=jplan, port=tplan, tmp=tmp_path_factory.mktemp("pair"),
                energy=energy, luts={n: m.lut for n, m in models.items()},
                shares={n: m.energy / e_total for n, m in models.items()})


def test_profile_stage_stats_match_jax(stage_pair):
    jplan, tplan = stage_pair["jax"], stage_pair["port"]
    assert tplan.completed == jplan.completed == ("profile", "energy_model")
    assert set(tplan.stats) == set(jplan.stats) and len(tplan.stats) == 5
    for name, js in jplan.stats.items():
        ts = tplan.stats[name]
        assert isinstance(ts, TStats)
        assert ts.n_transitions == js.n_transitions
        for f in NAMES:
            g, w = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
            if f == "energy_sum":
                np.testing.assert_allclose(g, w, rtol=2e-3,
                                           err_msg=f"{name}.{f}")
                np.testing.assert_allclose(g, stage_pair["energy"][name],
                                           rtol=1e-4, err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name}.{f}")
    assert tplan.metrics["acc_base"] == jplan.metrics["acc_base"]


def test_energy_model_stage_matches_jax(stage_pair):
    jplan, tplan = stage_pair["jax"], stage_pair["port"]
    assert set(tplan.luts) == set(jplan.luts) == set(stage_pair["luts"])
    for name, jl in stage_pair["luts"].items():
        seen = np.asarray(jplan.stats[name].count) > 0
        assert seen.any()
        np.testing.assert_allclose(tplan.luts[name].numpy()[seen],
                                   np.asarray(jl)[seen], rtol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(tplan.luts[name].numpy()[seen],
                                   np.asarray(jplan.luts[name])[seen],
                                   rtol=2e-3, err_msg=name)
        assert torch.isfinite(tplan.luts[name]).all()
    assert set(tplan.shares) == set(jplan.shares)
    for name, s in stage_pair["shares"].items():
        np.testing.assert_allclose(tplan.shares[name], s, rtol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(tplan.shares[name], jplan.shares[name],
                                   rtol=2e-3, err_msg=name)
    np.testing.assert_allclose(sum(tplan.shares.values()), 1.0, rtol=1e-6)


def test_plans_cross_load_after_energy_model(stage_pair):
    tmp = stage_pair["tmp"]
    stage_pair["port"].save(tmp / "port")
    doc = json.loads((tmp / "port.json").read_text())
    failed = [g for g in validate_plan_doc(doc) if not g["pass"]]
    assert not failed, failed
    in_jax = JPlan.load(tmp / "port")
    JConfig.from_dict(in_jax.config)
    assert in_jax.completed == ("profile", "energy_model")
    for name, ts in stage_pair["port"].stats.items():
        js = in_jax.stats[name]
        assert isinstance(js, JStats) and js.n_transitions == ts.n_transitions
        for f in NAMES:
            np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                          getattr(ts, f).numpy())
    assert set(in_jax.opt_state) == {"step", "mu", "nu"}

    stage_pair["jax"].save(tmp / "jax")
    in_port = TPlan.load(tmp / "jax")
    for name, js in stage_pair["jax"].stats.items():
        ts = in_port.stats[name]
        assert isinstance(ts, TStats)
        for f in NAMES:
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)))
    assert in_port.shares == stage_pair["jax"].shares


def test_cli_profile_writes_a_plan_jax_loads(tmp_path):
    out = tmp_path / "profiled"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "profile", "--arch", "lenet5",
         "--steps", "0", "--device", "cpu", "--quiet", "--plan-out",
         str(out)], capture_output=True, text=True, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(out.with_suffix(".json").read_text())
    assert not [g for g in validate_plan_doc(doc) if not g["pass"]]
    plan = JPlan.load(out)
    assert plan.completed == ("profile", "energy_model")
    assert set(plan.stats) == {cl.name for cl in jcnn.lenet5().comp_layers}
    np.testing.assert_allclose(sum(plan.shares.values()), 1.0, rtol=1e-6)


class _WorkStarted(Exception):
    pass


@pytest.mark.parametrize("override,option", [
    ({"schedule": {"search_mode": "batched"}}, "batched sweep"),
    ({"profile": {"verify_cosim": True}}, "cosim gate")])
def test_batched_sweep_and_cosim_configs_start_work(override, option):
    """The batched schedule sweep's and the cosim gate's configs go on to
    work."""
    cfg = TConfig.from_dict(_cfg_dict()).with_overrides(override)
    pipe = TPipeline(cfg, device="cpu")

    def init():
        raise _WorkStarted

    pipe.target.runner.init = init
    with pytest.raises(_WorkStarted):
        pipe.run()
    assert not pipe.plan.completed


def test_runner_batched_sweep_equals_each_candidate_alone():
    """The runner's batched candidate sweep runs: two stacked LeNet-5
    candidates train and evaluate as each does alone, bit for bit."""
    from repro_torch._device import tree_leaves
    from repro_torch.core import qat as tqat

    runner = TRunner(tcnn.lenet5(), _TorchImages(), batch_size=2,
                     device="cpu")
    params, state, opt_state, comp = runner.init()
    comps = [comp, dict(comp, conv2=dict(comp["conv2"], mask=tqat.
             magnitude_prune_mask(params["conv2"]["w"], 0.5)))]
    stacked = tqat.stack_pytrees(comps)
    p_s, s_s, o_s, loss = runner.train_batched(
        *(tqat.broadcast_pytree(t, 2) for t in (params, state, opt_state)),
        stacked, 2)
    accs = runner.accuracy_batched(p_s, s_s, stacked, n_batches=2)
    for j, c in enumerate(comps):
        p1, s1, _, l1 = runner.train(params, state, opt_state, c, 2)
        assert loss[j] == l1
        for a, b in zip(tree_leaves(p1), tree_leaves(p_s)):
            assert torch.equal(a, b[j])
        assert accs[j] == runner.accuracy(p1, s1, c, n_batches=2)
    np.testing.assert_array_equal(
        runner.accuracy_comps(params, state, stacked, n_batches=2),
        [runner.accuracy(params, state, c, n_batches=2) for c in comps])
    np.testing.assert_array_equal(
        runner.accuracy_gather(p_s, s_s, stacked, [0, 1], n_batches=2),
        accs)
