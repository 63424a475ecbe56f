"""Port parity for the LM target's compression stages (reduced olmo-1b):
the comp tree and unit walk, the uniform-trace energy LUT, energy_model /
schedule / export run in the port on the JAX package's saved plans, the
stacked serve artifacts, plans crossing between the packages, and the CLI.

The JAX reference runs once per module (`ref`): its pipeline through each
of profile, energy_model, schedule and export, each plan saved.

Tolerances and why:
  * the uniform-trace LUT from the JAX package's own draws: rel 1e-6 (the
    same integer MAC events priced in float32, the mean summed in another
    order);
  * unit energies, shares, decision energies: rel 1e-5 (float32 sums of
    the same integer counts against the same LUT);
  * comp trees, decisions' integers, exported artifacts: equal (integer
    encodes of identical floats);
  * `lut_parity_report` on the same activations: abs 1e-6 (both values are
    float32 round-off, ~1e-7).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import energy_lut as jelut
from repro.core import lm_compress as jlc
from repro.models.lm import build_lm as jbuild
from repro.pipeline.config import reduced_lm_config as j_reduced_lm
from repro.pipeline.pipeline import Pipeline as JPipeline
from repro.pipeline.plan import CompressionPlan as JPlan
from repro_torch.configs import get_config as tget
from repro_torch.core import lm_compress as tlc
from repro_torch.core.energy_lut import uniform_lut_from_draws, uniform_trace_lut
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn.spec import flatten_with_names as tflat
from repro_torch.nn.spec import params_from_numpy
from repro_torch.pipeline import targets as ttargets
from repro_torch.pipeline.config import PipelineConfig as TConfig
from repro_torch.pipeline.config import reduced_lm_config as t_reduced_lm
from repro_torch.pipeline.pipeline import Pipeline as TPipeline
from repro_torch.pipeline.plan import CompressionPlan as TPlan

ROOT = Path(__file__).resolve().parents[1]
STAGES = ("profile", "energy_model", "schedule", "export")
ART_FIELDS = ("packed", "codebook", "scale")
ART_META = ("k_dim", "n_dim", "block_k", "kind", "kernel")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work in this file runs on one thread: beside the
    suite's parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t2n(t):
    return t.detach().cpu().numpy()


def j2t(tree):
    return params_from_numpy(jax.device_get(tree), "cpu")


def jax_draws(n_mc=2048, seed=23):
    """The draws of the JAX package's `uniform_trace_lut`."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return [np.asarray(jax.random.randint(k, (1, n_mc), lo, hi))[0]
            for k, lo, hi in ((k1, -128, 128), (k2, -128, 128),
                              (k3, -(1 << 21), 1 << 21))]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's reduced-LM pipeline, each stage's plan saved."""
    base = tmp_path_factory.mktemp("lm_plans")
    pipe = JPipeline(j_reduced_lm("olmo-1b"))
    paths = {}
    for stage in STAGES:
        pipe.run_until(stage)
        paths[stage] = base / stage
        pipe.plan.save(paths[stage])
    return dict(paths=paths, jm=pipe.target.model, base=base,
                lut=torch.from_numpy(np.array(jelut.uniform_trace_lut())))


def jplan(ref, stage):
    return JPlan.load(ref["paths"][stage])


def tpipe(ref, stage, monkeypatch):
    """The port resuming the JAX plan saved after ``stage``, pricing with
    the JAX package's LUT (the two packages' Monte-Carlo draws differ)."""
    monkeypatch.setattr(ttargets, "uniform_trace_lut",
                        lambda device="cpu": ref["lut"].to(device))
    return TPipeline.from_plan(TPlan.load(ref["paths"][stage]), device="cpu")


def assert_art_equal(a, b, name):
    for f in ART_FIELDS:
        np.testing.assert_array_equal(t2n(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{name}.{f}")
    for f in ART_META:
        assert getattr(a, f) == getattr(b, f), (name, f)


# ------------------------------------------------------------- comp, units


def test_comp_spec_and_units_match_jax(ref):
    jm = ref["jm"]
    tm = TPipeline(t_reduced_lm("olmo-1b"), device="cpu").target.model
    js, ts = tflat(jlc.make_lm_comp_spec(jm)), tflat(tlc.make_lm_comp_spec(tm))
    assert list(js) == list(ts)
    for name, s in js.items():
        assert tuple(s.shape) == tuple(ts[name].shape), name
        assert tuple(s.axes) == tuple(ts[name].axes), name
        assert str(jnp.dtype(s.dtype)) == str(ts[name].dtype).split(".")[1]
    assert tlc.lm_comp_layers(tm) == jlc.lm_comp_layers(jm)
    plan = jplan(ref, "schedule")
    tcomp, tparams = j2t(plan.comp), j2t(plan.params)
    jwalk = [(n, layout) for n, _, _, layout in
             jlc.iter_eligible_units(jm, plan.params, plan.comp)]
    twalk = [(n, layout) for n, _, _, layout in
             tlc.iter_eligible_units(tm, tparams, tcomp)]
    assert twalk == jwalk and len(twalk) == 14
    init = tflat(tlc.init_lm_comp(tm, device="cpu"))
    for name, v in tflat(jax.device_get(jlc.init_lm_comp(jm))).items():
        np.testing.assert_array_equal(t2n(init[name]), v)
        assert str(init[name].dtype).split(".")[1] == str(v.dtype)


def test_codebook_updates_match_jax(ref):
    jm = ref["jm"]
    tm = TPipeline(t_reduced_lm("olmo-1b"), device="cpu").target.model
    jc = jlc.restrict_all_codebooks(jm, jlc.init_lm_comp(jm),
                                    jlc.symmetric_codebook_values(8))
    jc = jlc.set_codebook(jc, "blocks/g0/attn/wv", [-3, 0, 5], layer=1)
    tc = tlc.restrict_all_codebooks(tm, tlc.init_lm_comp(tm, device="cpu"),
                                    tlc.symmetric_codebook_values(8))
    tc = tlc.set_codebook(tc, "blocks/g0/attn/wv", [-3, 0, 5], layer=1)
    jf, tf = tflat(jax.device_get(jc)), tflat(tc)
    assert list(jf) == list(tf)
    for name, v in jf.items():
        np.testing.assert_array_equal(t2n(tf[name]), v, err_msg=name)
    for k in (1, 4, 5, 16, 32):
        assert tlc.symmetric_codebook_values(k) == \
            jlc.symmetric_codebook_values(k)
    # the expert units: per-(layer, expert) codebooks, a None index over its
    # whole axis, on the reduced phi3.5-moe
    jmm = jbuild(jget("phi3.5-moe-42b-a6.6b").scaled_down())
    tmm = tbuild(tget("phi3.5-moe-42b-a6.6b").scaled_down())
    jc = jlc.init_lm_comp(jmm)
    tc = tlc.init_lm_comp(tmm, device="cpu")
    for path, values, layer, expert in (
            ("blocks/g0/moe/w_gate", [0, 1], None, None),
            ("blocks/g0/moe/w_gate", [-3, 0, 5], 1, 2),
            ("blocks/g0/moe/w_up", [-8, 0, 8, 9], None, 3),
            ("blocks/g0/moe/w_down", [1, 2], 0, None),
            ("blocks/g0/attn/wq", [0, 4], 1, None)):
        jc = jlc.set_codebook(jc, path, values, layer=layer, expert=expert)
        tc = tlc.set_codebook(tc, path, values, layer=layer, expert=expert)
        jf, tf = tflat(jax.device_get(jc)), tflat(tc)
        assert list(jf) == list(tf)
        for name, v in jf.items():
            np.testing.assert_array_equal(t2n(tf[name]), v, err_msg=name)
    assert tuple(tc["blocks"]["g0"]["moe/w_gate"]["codebook"].shape) == \
        (tmm.n_rep, tmm.cfg.n_experts, 32)


# ------------------------------------------------------------ energy model


def test_uniform_trace_lut_from_jax_draws():
    got = uniform_lut_from_draws(*(torch.from_numpy(d) for d in jax_draws()))
    want = np.asarray(jelut.uniform_trace_lut())
    np.testing.assert_allclose(t2n(got), want, rtol=1e-6)


def test_uniform_trace_lut_is_seeded():
    a, b = uniform_trace_lut(), uniform_trace_lut()
    assert torch.equal(a, b) and a.shape == (256,) and a.dtype == torch.float32
    assert torch.isfinite(a).all() and (a > 0).all()
    assert not torch.equal(a, uniform_trace_lut(seed=24))
    # same distribution as the JAX package's draws: within Monte-Carlo noise
    want = np.asarray(jelut.uniform_trace_lut())
    assert np.abs(t2n(a) / want - 1).max() < 0.05


def test_energy_model_on_jax_profile_plan(ref, monkeypatch):
    pipe = tpipe(ref, "profile", monkeypatch)
    plan = pipe.run_until("energy_model")
    want = jplan(ref, "energy_model")
    assert list(plan.shares) == list(want.shares)
    np.testing.assert_allclose(list(plan.shares.values()),
                               list(want.shares.values()), rtol=1e-5)
    np.testing.assert_allclose(plan.metrics["energy_per_token"],
                               want.metrics["energy_per_token"], rtol=1e-5)
    np.testing.assert_array_equal(t2n(plan.luts["uniform"]),
                                  t2n(ref["lut"]))


def test_schedule_on_jax_energy_plan(ref, monkeypatch):
    plan = tpipe(ref, "energy_model", monkeypatch).run_until("schedule")
    want = jplan(ref, "schedule")
    exact = ("layer", "prune_ratio", "k", "accuracy", "accepted", "tried")
    assert [{k: d[k] for k in exact} for d in plan.decisions] == \
        [{k: d[k] for k in exact} for d in want.decisions]
    for key in ("share", "energy_before", "energy_after"):
        np.testing.assert_allclose([d[key] for d in plan.decisions],
                                   [d[key] for d in want.decisions],
                                   rtol=1e-5)
    for key in ("energy_before", "energy_after"):
        np.testing.assert_allclose(plan.metrics[key], want.metrics[key],
                                   rtol=1e-5)
    assert plan.metrics["compress_k"] == want.metrics["compress_k"] == 4
    jf, tf = tflat(jax.device_get(want.comp)), tflat(plan.comp)
    for name, v in jf.items():
        np.testing.assert_array_equal(t2n(tf[name]), v, err_msg=name)


# ------------------------------------------------------------------ export


def test_export_of_jax_schedule_plan_is_byte_identical(ref, monkeypatch):
    plan = tpipe(ref, "schedule", monkeypatch).run_until("export")
    want = jplan(ref, "export")
    assert list(plan.artifacts) == list(want.artifacts)
    assert len(plan.artifacts) == 14
    for name, art in want.artifacts.items():
        assert_art_equal(plan.artifacts[name], art, name)
    assert plan.stats["export"]["skip_report"] == \
        want.stats["export"]["skip_report"] == []
    for key in ("export_layers", "export_weight_bytes_packed",
                "export_weight_bytes_dense_int8", "export_skipped"):
        assert plan.metrics[key] == want.metrics[key], key
    assert plan.metrics["export_parity_max_rel_err"] < 1e-6


def test_lut_parity_report_with_injected_x_matches_jax(ref):
    plan = jplan(ref, "export")
    jm = ref["jm"]
    tm = TPipeline(t_reduced_lm("olmo-1b"), device="cpu").target.model
    xs = {k: np.asarray(jax.random.normal(jax.random.PRNGKey(2), (4, k)))
          for k in {a.k_dim for a in plan.artifacts.values()}}
    want = jlc.lut_parity_report(jm, plan.params, plan.comp, plan.artifacts,
                                 check_units=14)
    got = tlc.lut_parity_report(
        tm, j2t(plan.params), j2t(plan.comp),
        {k: TPlan.load(ref["paths"]["export"]).artifacts[k]
         for k in plan.artifacts}, check_units=14,
        x={k: torch.from_numpy(v) for k, v in xs.items()})
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               atol=1e-6)


def test_attach_serve_artifacts_matches_jax(ref):
    plan = jplan(ref, "schedule")
    jm = ref["jm"]
    tm = TPipeline(t_reduced_lm("olmo-1b"), device="cpu").target.model
    jcomp, jn = jlc.attach_serve_artifacts(jm, plan.params, plan.comp)
    tcomp, tn = tlc.attach_serve_artifacts(tm, j2t(plan.params),
                                           j2t(plan.comp))
    assert tn == jn == 7
    for unit, entry in jcomp["blocks"]["g0"].items():
        art = tcomp["blocks"]["g0"][unit]["serve"]
        assert art.packed.shape[0] == 2
        assert_art_equal(art, entry["serve"], unit)


# ------------------------------------------------------------------ plans


def test_lm_plans_cross_between_packages(ref, monkeypatch, tmp_path):
    """The port's export plan loads in the JAX package (comp trees with
    stacked leaves, artifacts keyed ``blocks/g0/attn/wq[1]``, the uniform
    LUT), and the JAX package's in the port, leaf for leaf."""
    plan = tpipe(ref, "schedule", monkeypatch).run_until("export")
    plan.save(tmp_path / "port")
    back = JPlan.load(tmp_path / "port")
    want = jplan(ref, "export")
    assert back.completed == want.completed == STAGES
    for section in ("params", "comp", "luts"):
        jf = tflat(jax.device_get(getattr(want, section)))
        bf = tflat(jax.device_get(getattr(back, section)))
        assert list(jf) == list(bf), section
        for name, v in jf.items():
            np.testing.assert_array_equal(np.asarray(bf[name]), v)
            assert np.asarray(bf[name]).dtype == v.dtype, name
    for name, art in want.artifacts.items():
        for f in ART_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(
                back.artifacts[name], f)), np.asarray(getattr(art, f)))
    again = TPlan.load(ref["paths"]["export"])
    assert list(again.artifacts) == list(want.artifacts)
    assert again.comp["blocks"]["g0"]["attn/wq"]["mask"].dtype == torch.int8


# -------------------------------------------------------------- boundaries


def _lm_option(option, tmp_path):
    """(config overrides, last stage) that exercise one LM option on the
    reduced preset, with what the option needs on disk made under
    ``tmp_path``."""
    if option == "qat_steps":
        return {"train": {"qat_steps": 2}}, "profile"
    if option == "ckpt_dir":
        from repro_torch.checkpoint import CheckpointManager

        params = TPipeline(t_reduced_lm("olmo-1b"), device="cpu").run_until(
            "profile").params
        shifted = {"params": {k: v for k, v in params.items()}}
        shifted["params"]["embed"] = {"table": params["embed"]["table"] + 1}
        CheckpointManager(tmp_path / "ckpt", async_save=False).save(
            7, shifted)
        return {"target": {"ckpt_dir": str(tmp_path / "ckpt")}}, "profile"
    if option == "plans_dir":
        plans = tmp_path / "plans"
        plans.mkdir()
        TPipeline(t_reduced_lm("olmo-1b"), device="cpu").run_until(
            "schedule").save(plans / "olmo-k4")
        return {"serve": {"plans_dir": str(plans)}}, "serve"
    return {"serve": {"plans": ("k4", "base")}}, "serve"


@pytest.mark.parametrize("option", ["qat_steps", "ckpt_dir", "plans_dir",
                                    "plans"])
def test_lm_options_run_the_stage_they_change(option, tmp_path):
    """Each LM option (LM QAT steps, a checkpoint to restore, a fleet from
    a plan directory or from plan specs) runs on the reduced preset, and
    the stage it changes produces its result."""
    over, stage = _lm_option(option, tmp_path)
    pipe = TPipeline(t_reduced_lm("olmo-1b").with_overrides(over),
                     device="cpu")
    plan = pipe.run_until(stage)
    assert list(plan.completed) == list(STAGES + ("serve",))[
        :STAGES.index(stage) + 1 if stage in STAGES else None]
    init = TPipeline(t_reduced_lm("olmo-1b"), device="cpu").run_until(
        "profile").params
    table = plan.params["embed"]["table"]
    if option == "qat_steps":
        losses = pipe.target.last_qat["loss"]
        assert len(losses) == 2 and all(np.isfinite(losses))
        assert not torch.equal(table, init["embed"]["table"])
    elif option == "ckpt_dir":
        assert torch.equal(table, init["embed"]["table"] + 1)
        assert torch.equal(plan.params["blocks"]["g0"]["attn"]["wq"],
                           init["blocks"]["g0"]["attn"]["wq"])
    else:
        m = plan.metrics
        want = {"plans_dir": {"olmo-k4"}, "plans": {"k4", "base"}}[option]
        assert m["serve_mode"] == "fleet"
        assert set(m["serve_plans"].split(",")) == want
        assert m["serve_requests"] == pipe.cfg.serve.requests
        assert m["serve_recompiles_after_warmup"] == 0
        assert len(pipe.target.last_serve_results) == m["serve_requests"]


def test_default_lm_config_parses_in_both_packages():
    t = t_reduced_lm("olmo-1b")
    assert t.to_dict() == j_reduced_lm("olmo-1b").to_dict()
    assert TConfig.from_dict(t.to_dict()).train.qat_steps == 0


# --------------------------------------------------------------------- CLI


def _cli(*args, cwd):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "repro_torch", *args],
                          capture_output=True, text=True, env=env, cwd=cwd,
                          timeout=600)


def test_cli_lm_compress_export_and_serve_boundary(ref, tmp_path):
    """``compress --target lm --reduced --compress-k 4`` runs profile
    through export and names ``serve --plan-in`` for the serve stage;
    ``serve`` on its plan runs that stage (the engine on the k = 4
    fake-quant forward, checked against the oneshot fallback);
    ``export --plan-in`` of the JAX package's schedule plan writes its
    artifacts byte for byte."""
    proc = _cli("compress", "--target", "lm", "--arch", "olmo-1b",
                "--reduced", "--compress-k", "4", "--device", "cpu",
                "--quiet", "--plan-out", str(tmp_path / "base"), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "serve --plan-in" in proc.stdout
    plan = TPlan.load(tmp_path / "base")
    assert plan.completed == STAGES
    assert len(plan.artifacts) == 14 and plan.metrics["compress_k"] == 4

    proc = _cli("serve", "--plan-in", str(tmp_path / "base"), "--device",
                "cpu", "--verify-oneshot", "--quiet", "--plan-out",
                str(tmp_path / "served"), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    served = TPlan.load(tmp_path / "served")
    assert served.completed == STAGES + ("serve",)
    m = served.metrics
    assert m["serve_mode"] == "engine" and m["serve_requests"] == 2
    assert m["serve_recompiles_after_warmup"] == 0
    assert m["serve_parity_engine_vs_oneshot"] is True
    assert m["serve_cache_compress_k"] == 4

    proc = _cli("export", "--plan-in", str(ref["paths"]["schedule"]),
                "--device", "cpu", "--quiet", "--plan-out",
                str(tmp_path / "exported"), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    got, want = TPlan.load(tmp_path / "exported"), jplan(ref, "export")
    for name, art in want.artifacts.items():
        assert_art_equal(got.artifacts[name], art, name)


@pytest.mark.parametrize("args", [
    ("--reduced",),
    ("--reduced", "--target", "cnn"),
])
def test_cli_compress_k_needs_an_lm_target(args, capsys):
    """``--compress-k`` restricts an LM's codebooks: without ``--target
    lm`` it is an error before any stage runs, not a change of target."""
    from repro_torch.pipeline.cli import main

    with pytest.raises(SystemExit) as exc:
        main(["compress", *args, "--compress-k", "4", "--device", "cpu",
              "--quiet"])
    assert exc.value.code == 2
    assert "--target lm" in capsys.readouterr().err
