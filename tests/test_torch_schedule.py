"""Weight selection and the serial layer-wise schedule in the port against
the JAX package, and the ``compress`` command end to end.

The schedule pair starts from one JAX ``run_until("energy_model")`` plan of
`reduced_cnn_config` (serial search), which both packages then run through
``schedule`` on the same numpy batches. The JAX package's Monte-Carlo LUTs
(drawn with `jax.random`, which the port cannot replay) are handed to the
port's energy models, as the tile indices and draws are in
test_torch_profile_stage.py. The JAX package draws those LUTs with 256
Monte-Carlo samples here instead of its default 4096 (the draw over the
65,536 activation-pair bins is most of its energy_model stage on a CPU);
both packages then read the same LUTs.

Tolerances and why:
  * greedy elimination, candidate sets, candidate order: exact (the same
    host-side float64 arithmetic on the same arrays).
  * the schedule's decisions (layer, prune, k, MSR depth, accepted, what was
    tried), pruning masks, final codebooks and accuracies: exact.
  * the decisions' shares and energies: rel 1e-5 (float32 histograms and
    LUT sums).
  * ``energy_saving`` after the final fine-tune: rel 1e-4. It is measured
    after 8 + 10 + 15 QAT steps on a loss near 1e-8, where float32
    round-off of the JAX package's convolutions flips a few int8 weights
    that AdamW then moves a full step (ROADMAP.md queue 3); measured 3.0e-5
    off, against the 1e-5 the stage's other energies meet.
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

from repro.core import energy_lut as j_energy_lut
from repro.core import schedule as jsched
from repro.core import weight_selection as jsel
from repro.core.layer_energy import LayerEnergyModel as JModel
from repro.core.layer_energy import MatmulDims as JDims
from repro.core.runner import CnnRunner as JRunner
from repro.nn import cnn as jcnn
from repro.pipeline.config import reduced_cnn_config as j_reduced
from repro.pipeline.pipeline import Pipeline as JPipeline
from repro.pipeline.plan import CompressionPlan as JPlan
from repro.pipeline.plan import decision_dict as j_decision_dict
from repro.pipeline.schema import validate_plan_doc
from repro.pipeline.targets import CnnTarget as JTarget
from repro_torch.core import schedule as tsched
from repro_torch.core import weight_selection as tsel
from repro_torch.core.layer_energy import LayerEnergyModel as TModel
from repro_torch.core.layer_energy import MatmulDims as TDims
from repro_torch.core.runner import CnnRunner as TRunner
from repro_torch.kernels.fake_quant import fake_quant as tkernel
from repro_torch.nn import cnn as tcnn
from repro_torch.nn.spec import params_from_numpy
from repro_torch.pipeline.config import ScheduleConfig as TScheduleConfig
from repro_torch.pipeline.config import SelectionConfig as TSelectionConfig
from repro_torch.pipeline.config import reduced_cnn_config as t_reduced
from repro_torch.pipeline.pipeline import Pipeline as TPipeline
from repro_torch.pipeline.plan import CompressionPlan as TPlan
from repro_torch.pipeline.plan import decision_dict as t_decision_dict
from repro_torch.pipeline.targets import CnnTarget as TTarget

ROOT = Path(__file__).resolve().parents[1]
_SPLIT = {"train": 0, "val": 1, "test": 2}
SERIAL = {"schedule": {"search_mode": "serial"}}
N_MC = 256                  # Monte-Carlo samples of the JAX grouped LUT


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


class _NumpyImages:
    """A learnable CIFAR-like numpy stream, built as `SyntheticImages` is
    (smooth class templates, brightness jitter 0.2, pixel noise 0.45),
    handed to both packages' runners."""

    def __init__(self, seed=5, num_classes=10):
        rng = np.random.default_rng([seed, 99])
        up = np.kron(rng.normal(size=(num_classes, 8, 8, 3)),
                     np.ones((1, 4, 4, 1)))
        self.templates = (up / up.std()).astype(np.float32)
        self.seed, self.num_classes = seed, num_classes

    def arrays(self, step, batch_size, split):
        rng = np.random.default_rng([self.seed, _SPLIT[split], step])
        y = rng.integers(0, self.num_classes, batch_size)
        x = (self.templates[y] * (1 + 0.2 * rng.normal(size=(batch_size, 1,
                                                              1, 1)))
             + 0.45 * rng.normal(size=(batch_size, 32, 32, 3)))
        return x.astype(np.float32), y


class _JaxImages(_NumpyImages):
    def batch(self, step, batch_size, split="train"):
        x, y = self.arrays(step, batch_size, split)
        return jnp.asarray(x), jnp.asarray(y, jnp.int32)


class _TorchImages(_NumpyImages):
    def batch(self, step, batch_size, split="train", *, device):
        x, y = self.arrays(step, batch_size, split)
        return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


# --------------------------------------------------------- weight selection


def _energy_model(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 400, 256).astype(np.float32)
    counts[rng.random(256) < 0.4] = 0
    counts[128] += 900                                   # zeros dominate
    lut = (1.0 + rng.random(256)).astype(np.float32)
    dims = dict(m=64, k=144, n=4096)
    return (JModel("l", JDims(**dims), jnp.asarray(lut), jnp.asarray(counts)),
            TModel("l", TDims(**dims), torch.from_numpy(lut),
                   torch.from_numpy(counts)))


def _fake_eval(values, n_batches):
    """A deterministic accuracy of a restricted value set: dropping large
    magnitudes costs more, and some values are essential."""
    missing = set(range(-40, 41, 8)) - set(values)
    penalty = sum(abs(v) for v in missing) * 1e-4 + 0.02 * (24 in missing)
    return round(0.9 - penalty + 0.001 * n_batches, 6)


@pytest.mark.parametrize("seed,k_target,max_score,delta", [
    (0, 16, 32, 0.03), (1, 12, 3, 0.03), (2, 20, 5, 0.005), (3, 8, 32, 0.1)])
def test_greedy_elimination_matches_jax(seed, k_target, max_score, delta):
    jm, tm = _energy_model(seed)
    kw = dict(k_init=32, k_target=k_target, delta_acc=delta,
              max_score_candidates=max_score, accept_batches=4)
    jcfg, tcfg = jsel.SelectionConfig(**kw), TSelectionConfig(**kw)
    init_j = jsel.initial_candidate_set(jm.counts, jm.lut, jcfg)
    init_t = tsel.initial_candidate_set(tm.counts, tm.lut, tcfg)
    assert init_t == init_j and 0 in init_t and len(init_t) == 32
    j_vals, j_rep = jsel.greedy_backward_elimination(
        jm, init_j, jcfg, 0.9, eval_with_codebook=_fake_eval)
    t_vals, t_rep = tsel.greedy_backward_elimination(
        tm, init_t, tcfg, 0.9, eval_with_codebook=_fake_eval)
    assert t_vals == j_vals
    for f in ("layer", "initial", "final", "removed", "essential",
              "acc_checks"):
        assert getattr(t_rep, f) == getattr(j_rep, f), f
    for f in ("energy_before", "energy_after"):
        np.testing.assert_allclose(getattr(t_rep, f), getattr(j_rep, f),
                                   rtol=1e-12)


@pytest.mark.parametrize("usage_weight", [0.0, 0.5, 1.0])
def test_candidate_sets_match_jax(usage_weight):
    jm, tm = _energy_model(7)
    cfg = dict(k_init=20, usage_weight=usage_weight)
    assert (tsel.initial_candidate_set(tm.counts, tm.lut,
                                       TSelectionConfig(**cfg))
            == jsel.initial_candidate_set(jm.counts, jm.lut,
                                          jsel.SelectionConfig(**cfg)))
    assert (tsel.naive_lowest_energy_set(tm.lut, 16)
            == jsel.naive_lowest_energy_set(jm.lut, 16))
    for w in (-128, -3, 0, 5, 127):
        vals = [-128, -5, -3, 0, 2, 5, 8, 127]
        assert tsel.nearest_other(vals, w) == jsel.nearest_other(vals, w)


def test_codebook_and_msr_comp_match_jax():
    w = np.zeros((3, 3, 2, 4), np.float32)
    from repro.core import qat as jqat
    from repro_torch.core import qat as tqat

    jcomp = {"a": jqat.identity_comp(w.shape), "b": jqat.identity_comp((4,))}
    tcomp = {"a": tqat.identity_comp(w.shape, device="cpu"),
             "b": tqat.identity_comp((4,), device="cpu")}
    j2 = jsel.msr_comp(jsel.codebook_comp(jcomp, "a", [5, -3, 0]), "a", 3)
    t2 = tsel.msr_comp(tsel.codebook_comp(tcomp, "a", [5, -3, 0]), "a", 3)
    assert t2["b"] is tcomp["b"] and tcomp["a"]["codebook_k"] == 0
    for k in ("codebook", "codebook_k", "msr_bits"):
        np.testing.assert_array_equal(t2["a"][k].numpy(),
                                      np.asarray(j2["a"][k]))
        assert t2["a"][k].shape == tuple(np.shape(j2["a"][k]))


# ------------------------------------------------------------ candidate order


def test_candidate_order_matches_jax():
    """With MSR depths in play, the measured-energy prior orders the
    candidates the same way in both packages."""
    rng = np.random.default_rng(4)
    model = jcnn.lenet5()
    from repro.nn.spec import init_params as j_init

    params = j_init(jax.random.PRNGKey(0), model.spec)
    jr = JRunner(model, _JaxImages(), batch_size=2)
    tr = TRunner(tcnn.lenet5(), _TorchImages(), batch_size=2, device="cpu")
    comp = jr.identity_comp(params)
    stats_lut = (1 + rng.random(256)).astype(np.float32)
    jmodels, tmodels = {}, {}
    for cl in model.comp_layers:
        dims = cl.matmul_dims(1)
        jmodels[cl.name] = JModel(cl.name, dims, jnp.asarray(stats_lut),
                                  jnp.zeros(256))
        tmodels[cl.name] = TModel(cl.name, TDims(dims.m, dims.k, dims.n),
                                  torch.from_numpy(stats_lut),
                                  torch.zeros(256))
    kw = dict(prune_ratios=(0.7, 0.3), k_targets=(8, 16),
              msr_bits=(0, 2, 4))
    jcfg, tcfg = jsched.ScheduleConfig(**kw), TScheduleConfig(**kw)
    assert tsched._config_order(tcfg) == jsched._config_order(jcfg)
    for layer in ("conv2", "fc1"):
        want = jsched._candidate_order(jr, params, comp, jmodels, layer, jcfg)
        got = tsched._candidate_order(tr, j2t(params), j2t(comp), tmodels,
                                      layer, tcfg)
        assert got == want
        assert got != tsched._config_order(tcfg)       # the prior reorders
    for k in (4, 7, 16, 32):
        from repro.core.lm_compress import symmetric_codebook_values

        assert tsched.symmetric_codebook_values(k) == \
            symmetric_codebook_values(k)


# ----------------------------------------------------- the schedule stage


@pytest.fixture(scope="module")
def schedule_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("schedule")
    jcfg = j_reduced().with_overrides(SERIAL)
    jrunner = JRunner(jcnn.lenet5(), _JaxImages(), batch_size=64,
                      lr=jcfg.target.lr)
    jpipe = JPipeline(JTarget(jcfg, runner=jrunner), jcfg)
    blended = j_energy_lut.blended_lut
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_energy_lut, "blended_lut",
                   lambda stats: blended(stats, n_mc=N_MC))
        jpipe.run_until("energy_model").save(tmp / "energy_model")
        jplan = jpipe.run_until("schedule")

    tcfg = t_reduced().with_overrides(SERIAL)
    start = TPlan.load(tmp / "energy_model")
    luts = dict(start.luts)
    trunner = TRunner(tcnn.lenet5(), _TorchImages(), batch_size=64,
                      lr=tcfg.target.lr, device="cpu")
    own_models = trunner.energy_models

    def energy_models(params, comp, stats=None, batch=1):
        return {n: TModel(n, m.dims, luts[n], m.counts)
                for n, m in own_models(params, comp, stats, batch).items()}

    trunner.energy_models = energy_models
    pipe = TPipeline.from_plan(start, cfg=tcfg, device="cpu")
    pipe.target = TTarget(tcfg, torch.device("cpu"), runner=trunner)
    before = tkernel.launches
    tplan = pipe.run_until("schedule")
    assert tkernel.launches == before             # CPU tensors: plain K3
    return dict(jax=jplan, port=tplan, pipe=pipe, tmp=tmp)


def test_serial_schedule_decisions_match_jax(schedule_pair):
    jplan, tplan = schedule_pair["jax"], schedule_pair["port"]
    assert tplan.completed == jplan.completed == (
        "profile", "energy_model", "schedule")
    assert len(tplan.decisions) == len(jplan.decisions) >= 1
    assert any(d["accepted"] for d in jplan.decisions)
    for t, j in zip(tplan.decisions, jplan.decisions):
        for f in ("layer", "prune_ratio", "k", "msr", "accepted", "tried",
                  "accuracy"):
            assert t[f] == j[f], (f, t[f], j[f])
        for f in ("share", "energy_before", "energy_after"):
            np.testing.assert_allclose(t[f], j[f], rtol=1e-5, err_msg=f)


def test_serial_schedule_codebooks_and_metrics_match_jax(schedule_pair):
    jplan, tplan = schedule_pair["jax"], schedule_pair["port"]
    assert set(tplan.comp) == set(jplan.comp)
    for name, jc in jplan.comp.items():
        tc = tplan.comp[name]
        for f in ("codebook", "codebook_k", "msr_bits", "mask"):
            np.testing.assert_array_equal(tc[f].numpy(), np.asarray(jc[f]),
                                          err_msg=f"{name}.{f}")
    for f in ("acc0", "acc_final", "accuracy_drop", "max_codebook"):
        assert tplan.metrics[f] == jplan.metrics[f], f
    for f in ("energy_before", "energy_after"):
        np.testing.assert_allclose(tplan.metrics[f], jplan.metrics[f],
                                   rtol=1e-4, err_msg=f)
    np.testing.assert_allclose(tplan.metrics["energy_before"],
                               jplan.metrics["energy_before"], rtol=1e-5)
    np.testing.assert_allclose(tplan.metrics["energy_saving"],
                               jplan.metrics["energy_saving"], rtol=1e-4)
    assert tplan.metrics["energy_saving"] > 0.1
    assert int(tplan.opt_state["step"]) == int(jplan.opt_state["step"])


def test_plan_load_keeps_scalar_shapes(schedule_pair):
    """0-d leaves (the optimizer step, codebook sizes, MSR depths) load as
    0-d tensors, as the JAX package wrote them."""
    start = TPlan.load(schedule_pair["tmp"] / "energy_model")
    assert start.opt_state["step"].shape == ()
    for name, c in start.comp.items():
        assert c["codebook_k"].shape == () and c["msr_bits"].shape == ()
        assert c["codebook"].shape == (32,)
    for c in schedule_pair["port"].comp.values():
        assert c["codebook_k"].shape == () and c["msr_bits"].shape == ()


def test_port_schedule_plan_exports_and_serves(schedule_pair):
    """The port's plan goes on through export and serve, and the JAX
    package loads the result."""
    plan = schedule_pair["pipe"].run()
    assert plan.completed[-1] == "serve"
    assert plan.metrics["serve_logit_rel_err"] < 2e-2
    plan.save(schedule_pair["tmp"] / "served")
    doc = json.loads((schedule_pair["tmp"] / "served.json").read_text())
    assert not [g for g in validate_plan_doc(doc) if not g["pass"]]
    back = JPlan.load(schedule_pair["tmp"] / "served")
    assert back.decisions == plan.decisions
    assert set(back.artifacts) == {d["layer"] for d in plan.decisions
                                   if d["accepted"]}


def test_decision_dict_matches_jax():
    for msr, tried in ((None, []), (3, [(0.5, 16, 3), (0.3, 24, 0)])):
        jd = jsched.LayerDecision("fc1", 0.25, 0.5 if msr else None,
                                  16 if msr else None, 10.0, 6.5, 0.875,
                                  msr is not None, tried, msr=msr)
        td = tsched.LayerDecision(*[getattr(jd, f) for f in (
            "layer", "share", "prune_ratio", "k", "energy_before",
            "energy_after", "accuracy", "accepted", "tried")], msr=msr)
        assert t_decision_dict(td) == j_decision_dict(jd)
        assert td.saving == jd.saving


# ------------------------------------------------------------------ the CLI


def _env():
    """The CLI subprocess's environment: the port on its path, one CPU
    thread (beside the suite's parallel workers more threads only contend
    for the cores)."""
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def test_cli_compress_reduced_writes_a_plan_jax_loads(tmp_path):
    out = tmp_path / "compressed"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "compress", "--reduced",
         "--search-mode", "serial", "--device", "cpu", "--quiet",
         "--plan-out", str(out)], capture_output=True, text=True,
        cwd=tmp_path, env=_env(), timeout=600)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(out.with_suffix(".json").read_text())
    assert not [g for g in validate_plan_doc(doc) if not g["pass"]]
    plan = JPlan.load(out)
    assert plan.completed == ("profile", "energy_model", "schedule",
                              "export", "serve")
    assert plan.metrics["qat_loss"] == plan.metrics["qat_loss"]   # not NaN
    assert plan.decisions and plan.metrics["serve_logit_rel_err"] < 2e-2
    assert int(plan.opt_state["step"]) > 60          # base QAT + fine-tunes


@pytest.fixture(scope="module")
def batched_port(schedule_pair):
    """The port's schedule stage under the default ``search_mode``
    (batched), from the same JAX-made plan and with the same JAX LUTs as
    the serial pair."""
    cfg = t_reduced()                     # search_mode: "batched" (default)
    assert cfg.schedule.search_mode == "batched"
    start = TPlan.load(schedule_pair["tmp"] / "energy_model")
    pipe = TPipeline.from_plan(start, cfg=cfg, device="cpu")
    runner = schedule_pair["pipe"].target.runner
    pipe.target = TTarget(cfg, torch.device("cpu"), runner=runner)
    return pipe, pipe.run_until("schedule")


def test_batched_schedule_raises_before_any_work(schedule_pair,
                                                 batched_port):
    """The batched sweep (the default ``search_mode``) runs the schedule
    stage from the same JAX-made plan and gives the port's serial walk's
    decisions, masks, codebooks and accuracies."""
    pipe, plan = batched_port
    serial = schedule_pair["port"]
    assert plan.decisions == serial.decisions
    for name, c in serial.comp.items():
        for f in ("codebook", "codebook_k", "msr_bits", "mask"):
            assert torch.equal(plan.comp[name][f], c[f]), (name, f)
    for f in ("acc0", "acc_final", "energy_saving"):
        assert plan.metrics[f] == serial.metrics[f], f
    # a plan already past the schedule resumes whatever the config says
    pipe.plan.completed = ("profile", "energy_model", "schedule", "export",
                           "serve")
    pipe.run()


def test_batched_schedule_matches_jax_batched(schedule_pair, batched_port):
    """The port's batched sweep against the JAX package's, from the same
    plan, LUTs and batches, at the serial schedule's bounds (module
    docstring)."""
    jcfg = j_reduced()
    assert jcfg.schedule.search_mode == "batched"
    jrunner = JRunner(jcnn.lenet5(), _JaxImages(), batch_size=64,
                      lr=jcfg.target.lr)
    jpipe = JPipeline.from_plan(
        JPlan.load(schedule_pair["tmp"] / "energy_model"),
        target=JTarget(jcfg, runner=jrunner), cfg=jcfg)
    blended = j_energy_lut.blended_lut
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_energy_lut, "blended_lut",
                   lambda stats: blended(stats, n_mc=N_MC))
        jplan = jpipe.run_until("schedule")
    tplan = batched_port[1]
    assert len(tplan.decisions) == len(jplan.decisions) >= 1
    for t, j in zip(tplan.decisions, jplan.decisions):
        for f in ("layer", "prune_ratio", "k", "msr", "accepted", "tried",
                  "accuracy"):
            assert t[f] == j[f], (f, t[f], j[f])
        for f in ("share", "energy_before", "energy_after"):
            np.testing.assert_allclose(t[f], j[f], rtol=1e-5, err_msg=f)
    for name, jc in jplan.comp.items():
        for f in ("codebook", "codebook_k", "msr_bits", "mask"):
            np.testing.assert_array_equal(tplan.comp[name][f].numpy(),
                                          np.asarray(jc[f]),
                                          err_msg=f"{name}.{f}")
    for f in ("acc0", "acc_final", "accuracy_drop", "max_codebook"):
        assert tplan.metrics[f] == jplan.metrics[f], f
    np.testing.assert_allclose(tplan.metrics["energy_saving"],
                               jplan.metrics["energy_saving"], rtol=1e-4)


def test_cli_compress_refuses_batched_search(tmp_path):
    """``compress --reduced`` with no ``--search-mode`` runs all five stages
    under the default batched sweep."""
    out = tmp_path / "batched"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "compress", "--reduced",
         "--device", "cpu", "--quiet", "--plan-out", str(out)],
        capture_output=True, text=True, cwd=tmp_path, env=_env(),
        timeout=600)
    assert proc.returncode == 0, proc.stderr
    plan = JPlan.load(out)
    assert plan.config["schedule"]["search_mode"] == "batched"
    assert plan.completed == ("profile", "energy_model", "schedule",
                              "export", "serve")
    assert plan.decisions and plan.metrics["serve_logit_rel_err"] < 2e-2
