"""Port parity for the serve slice as a whole: CNN forwards, export, and
plans crossing between the JAX package and `repro_torch` in both directions.

Tolerances and why:
  * ``QuantConfig.off()`` logits: rtol 1e-4 / atol 1e-5 — float32 round-off
    of different convolution summation orders, through a few layers.
  * ``.on()`` / ``.serve()`` logits: relative L2 < 1e-3 — the same round-off
    can move one activation across a `fake_quant_act` rounding boundary (one
    whole int8 step), which the later layers carry to the logits.
  * exported artifacts: identical bytes (integer encode of identical floats).
  * ``serve_logit_rel_err`` < 2e-2: the README's ``serve_forward_parity``.
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

from repro.core import qat as jqat
from repro.core.export import export_model as j_export_model
from repro.core.export import serve_conv as j_serve_conv
from repro.core.export import export_layer as j_export_layer
from repro.core.export import export_summary as j_export_summary
from repro.core.lm_compress import symmetric_codebook_values
from repro.core.stats import LayerStats
from repro.nn import cnn as jcnn
from repro.nn.layers import QuantConfig as JQ
from repro.nn.spec import init_params as j_init_params
from repro.pipeline.config import PipelineConfig as JConfig
from repro.pipeline.config import reduced_cnn_config
from repro.pipeline.pipeline import Pipeline as JPipeline
from repro.pipeline.plan import CompressionPlan as JPlan
from repro.pipeline.schema import validate_plan_doc
from repro_torch.core import export as texport
from repro_torch.core.stats import LayerStats as TLayerStats
from repro_torch.nn import cnn as tcnn
from repro_torch.nn.layers import QuantConfig as TQ
from repro_torch.nn.spec import params_from_numpy
from repro_torch.pipeline.config import PipelineConfig as TConfig
from repro_torch.pipeline.pipeline import Pipeline as TPipeline
from repro_torch.pipeline.plan import CompressionPlan as TPlan

ROOT = Path(__file__).resolve().parents[1]
ART_FIELDS = ("packed", "codebook", "scale")
ART_META = ("k_dim", "n_dim", "block_k", "kind", "kernel")


def j2t(tree):
    return params_from_numpy(jax.device_get(tree), "cpu")


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


def restricted_comp(model, params, prune_layer):
    """Per-layer symmetric codebooks alternating k=16 / k=4, plus a 50%
    magnitude mask on one layer."""
    comp = {}
    for i, cl in enumerate(model.comp_layers):
        w = model.get_weight(params, cl.name)
        c = jqat.identity_comp(w.shape, w.dtype)
        c["codebook"], c["codebook_k"] = jqat.make_codebook(
            symmetric_codebook_values(4 if i % 2 else 16))
        if cl.name == prune_layer:
            c["mask"] = jqat.magnitude_prune_mask(w, 0.5)
        comp[cl.name] = c
    return comp


MODELS = {"lenet5": ("fc1", 4), "resnet8": ("s2b1/conv1", 2)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def carried(request):
    """JAX params/state/comp/artifacts and their port counterparts."""
    arch = request.param
    prune, batch = MODELS[arch]
    jm = getattr(jcnn, arch)()
    key = jax.random.PRNGKey(0)
    p = j_init_params(key, jm.spec)
    s = j_init_params(key, jm.state_spec)
    comp = restricted_comp(jm, p, prune)
    arts = j_export_model(jm, p, comp)
    x = np.random.default_rng(0).normal(size=(batch, 32, 32, 3)).astype(
        np.float32)
    return dict(arch=arch, jm=jm, p=p, s=s, comp=comp, arts=arts, x=x,
                tm=getattr(tcnn, arch)(), tp=j2t(p), ts=j2t(s),
                tcomp=j2t(comp))


def test_export_model_byte_identical(carried):
    c = carried
    t_arts = texport.export_model(c["tm"], c["tp"], c["tcomp"])
    assert set(t_arts) == set(c["arts"]) == {cl.name
                                             for cl in c["jm"].comp_layers}
    for name, ja in c["arts"].items():
        ta = t_arts[name]
        for f in ART_FIELDS:
            np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                          np.asarray(getattr(ja, f)))
        for f in ART_META:
            assert getattr(ta, f) == getattr(ja, f)
    assert texport.export_summary(t_arts) == pytest.approx(
        j_export_summary(c["arts"]))


@pytest.mark.parametrize("mode", ["off", "on", "serve"])
def test_forward_parity(carried, mode):
    c = carried
    x = c["x"]
    jq = JQ.serve(use_ref_kernel=True) if mode == "serve" else getattr(JQ, mode)()
    tq = TQ.serve() if mode == "serve" else getattr(TQ, mode)()
    lj, _, _ = c["jm"].apply(c["p"], c["s"], jnp.asarray(x), qcfg=jq,
                             comp=c["comp"], serve=c["arts"])
    t_arts = texport.export_model(c["tm"], c["tp"], c["tcomp"])
    with torch.no_grad():
        lt, _ = c["tm"].apply(c["tp"], c["ts"], torch.from_numpy(x), qcfg=tq,
                              comp=c["tcomp"], serve=t_arts)
    if mode == "off":
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                                   atol=1e-5)
    else:
        assert rel(lt.numpy(), lj) < 1e-3


def test_serve_without_artifacts_is_fake_quant(carried):
    """Per-layer rule: a layer with no artifact serves on fake-quant."""
    c = carried
    x = torch.from_numpy(c["x"])
    l_on, _ = c["tm"].apply(c["tp"], c["ts"], x, qcfg=TQ.on(), comp=c["tcomp"])
    l_sv, _ = c["tm"].apply(c["tp"], c["ts"], x, qcfg=TQ.serve(),
                            comp=c["tcomp"], serve={})
    assert torch.equal(l_on, l_sv)


def test_served_forward_equals_fake_quant(carried):
    """Both paths round every product once from a float64 sum, so their int8
    activation quantization never drifts apart: the served logits equal the
    fake-quant logits to float32 ulps (not just the 2e-2 parity budget)."""
    c = carried
    x = torch.from_numpy(c["x"])
    t_arts = texport.export_model(c["tm"], c["tp"], c["tcomp"])
    with torch.no_grad():
        l_on, _ = c["tm"].apply(c["tp"], c["ts"], x, qcfg=TQ.on(),
                                comp=c["tcomp"])
        l_sv, _ = c["tm"].apply(c["tp"], c["ts"], x, qcfg=TQ.serve(),
                                comp=c["tcomp"], serve=t_arts)
    assert rel(l_sv.numpy(), l_on.numpy()) < 1e-6


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID")])
def test_serve_conv_layer_matches_pallas(stride, padding):
    rng = np.random.default_rng(stride)
    w = (rng.normal(size=(3, 3, 5, 12)) * 0.1).astype(np.float32)  # K=45
    comp = jqat.identity_comp(w.shape)
    comp["codebook"], comp["codebook_k"] = jqat.make_codebook(
        symmetric_codebook_values(16))
    x = rng.normal(size=(2, 9, 9, 5)).astype(np.float32)
    ja = j_export_layer(jnp.asarray(w), comp, kind="conv")
    want = j_serve_conv(jnp.asarray(x), ja, stride=stride, padding=padding,
                        activation="relu", interpret=True)
    ta = texport.export_layer(torch.from_numpy(w), j2t(comp), kind="conv")
    got = texport.serve_conv(torch.from_numpy(x), ta, stride=stride,
                             padding=padding, activation="relu")
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("c_in", [3, 5, 16])
def test_serve_conv_feeds_round_up_8_rows(c_in, monkeypatch):
    """The serve path's im2col rows are contiguous, round_up(K, 8) wide (not
    the pack block's K_pad) and zero past K, and serve the JAX package's
    padded-row output."""
    rng = np.random.default_rng(c_in)
    w = (rng.normal(size=(3, 3, c_in, 8)) * 0.1).astype(np.float32)
    comp = jqat.identity_comp(w.shape)
    comp["codebook"], comp["codebook_k"] = jqat.make_codebook(
        symmetric_codebook_values(16))
    x = rng.normal(size=(2, 6, 6, c_in)).astype(np.float32)
    seen = []
    real = texport.lut_matmul_fused

    def spy(rows, *a, **kw):
        seen.append(rows)
        return real(rows, *a, **kw)

    monkeypatch.setattr(texport, "lut_matmul_fused", spy)
    ta = texport.export_layer(torch.from_numpy(w), j2t(comp), kind="conv")
    got = texport.serve_conv(torch.from_numpy(x), ta, activation="relu")
    rows, = seen
    k = 9 * c_in
    assert tuple(rows.shape) == (2 * 6 * 6, -(-k // 8) * 8)
    assert ta.k_pad == -(-k // 128) * 128
    assert rows.is_contiguous() and not rows[:, k:].any()
    ja = j_export_layer(jnp.asarray(w), comp, kind="conv")
    want = j_serve_conv(jnp.asarray(x), ja, activation="relu",
                        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_lenet5_serve_feeds_unpadded_rows_at_the_gate(monkeypatch):
    """Every LUT-GEMM launch of a LeNet-5 served forward gets rows
    round_up(K, 8) wide, and the logits still match the JAX package's
    served forward (padded rows) at the serve gate."""
    c = {"jm": jcnn.lenet5(), "tm": tcnn.lenet5()}
    key = jax.random.PRNGKey(1)
    p = j_init_params(key, c["jm"].spec)
    comp = restricted_comp(c["jm"], p, "fc1")
    arts = j_export_model(c["jm"], p, comp)
    x = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    lj, _, _ = c["jm"].apply(p, {}, jnp.asarray(x),
                             qcfg=JQ.serve(use_ref_kernel=True), comp=comp,
                             serve=arts)
    t_arts = texport.export_model(c["tm"], j2t(p), j2t(comp))
    widths = []
    real = texport.lut_matmul_fused

    def spy(rows, packed, *a, **kw):
        widths.append((rows.shape[1], 2 * packed.shape[0]))
        return real(rows, packed, *a, **kw)

    monkeypatch.setattr(texport, "lut_matmul_fused", spy)
    with torch.no_grad():
        lt, _ = c["tm"].apply(j2t(p), {}, torch.from_numpy(x), qcfg=TQ.serve(),
                              comp=j2t(comp), serve=t_arts)
    k_dims = [t_arts[cl.name].k_dim for cl in c["tm"].comp_layers]
    assert widths == [(-(-k // 8) * 8, -(-k // 128) * 128) for k in k_dims]
    assert any(w < kp for w, kp in widths)
    assert rel(lt.numpy(), lj) < 1e-3


# ------------------------------------------------ a JAX plan, resumed here


@pytest.fixture(scope="module")
def jax_plan(tmp_path_factory):
    """A JAX CompressionPlan marked complete through ``schedule``, built
    cheaply (no QAT, no schedule run), plus the JAX pipeline's own export
    and serve of it."""
    tmp = tmp_path_factory.mktemp("plans")
    cfg = reduced_cnn_config().with_overrides(
        {"serve": {"use_ref_kernel": True}})
    jm = jcnn.lenet5()
    key = jax.random.PRNGKey(cfg.target.seed)
    params = j_init_params(key, jm.spec)
    comp = restricted_comp(jm, params, "conv2")
    names = [cl.name for cl in jm.comp_layers]
    plan = JPlan(config=cfg.to_dict(),
                 target={"kind": "cnn", "arch": "lenet5", "name": "lenet5"},
                 completed=("profile", "energy_model", "schedule"),
                 shares={n: 1.0 / len(names) for n in names},
                 params=params, state={}, comp=comp)
    base = tmp / "jax_plan"
    plan.save(base)
    ran = JPipeline.from_plan(JPlan.load(base)).run()
    return dict(base=base, tmp=tmp, jax_ran=ran)


def assert_artifacts_identical(got, want):
    assert set(got) == set(want)
    for name in want:
        for f in ART_FIELDS:
            g = getattr(got[name], f)
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            w = np.asarray(getattr(want[name], f))
            assert g.dtype == w.dtype, (name, f)
            np.testing.assert_array_equal(g, w)
        for f in ART_META:
            assert getattr(got[name], f) == getattr(want[name], f)


def test_jax_plan_resumes_in_port(jax_plan):
    plan = TPlan.load(jax_plan["base"])
    assert plan.completed == ("profile", "energy_model", "schedule")
    ran = TPipeline.from_plan(plan, device="cpu").run()
    ref = jax_plan["jax_ran"]
    assert ran.completed == ref.completed
    assert_artifacts_identical(ran.artifacts, ref.artifacts)
    assert ran.metrics["serve_layers"] == ref.metrics["serve_layers"] == 5
    assert ran.metrics["serve_logit_rel_err"] < 2e-2
    for k in ("export_layers", "export_weight_bytes_packed",
              "export_weight_bytes_dense_int8"):
        assert ran.metrics[k] == ref.metrics[k]


def test_cli_export_then_serve_cross_loads(jax_plan):
    """`python -m repro_torch export` on a JAX plan writes a plan the JAX
    package loads, with the JAX export's exact bytes and a document that
    passes the plan schema gate; `serve` then resumes the port's plan."""
    tmp = jax_plan["tmp"]
    out = tmp / "port_exported"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for cmd in (["export", "--plan-in", str(jax_plan["base"]),
                 "--plan-out", str(out)],
                ["serve", "--plan-in", str(out), "--plan-out",
                 str(tmp / "port_served")]):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch", *cmd, "--device", "cpu",
             "--quiet"], capture_output=True, text=True, env=env, cwd=tmp,
            timeout=300)
        assert proc.returncode == 0, proc.stderr
    exported = JPlan.load(out)
    assert exported.completed[-1] == "export"
    assert_artifacts_identical(exported.artifacts,
                               jax_plan["jax_ran"].artifacts)
    JConfig.from_dict(exported.config)           # embedded config parses
    for base in (out, tmp / "port_served"):
        doc = json.loads(base.with_suffix(".json").read_text())
        failed = [g for g in validate_plan_doc(doc) if not g["pass"]]
        assert not failed, failed
        assert base.with_suffix(".npz").exists()
    served = JPlan.load(tmp / "port_served")
    assert served.completed[-1] == "serve"
    assert served.metrics["serve_logit_rel_err"] < 2e-2


def test_plan_sections_round_trip_both_ways(tmp_path):
    """LayerStats nodes and bfloat16 leaves survive JAX -> port -> JAX."""
    rng = np.random.default_rng(0)
    stats = LayerStats(
        act_hist=jnp.asarray(rng.random((256, 256)), jnp.float32),
        group_hist=jnp.asarray(rng.random((50, 50)), jnp.float32),
        energy_sum=jnp.asarray(rng.random(256), jnp.float32),
        count=jnp.asarray(rng.integers(0, 9, 256), jnp.float32),
        n_transitions=1234)
    bf = jnp.asarray(rng.normal(size=(4, 3)), jnp.bfloat16)
    JPlan(config=TConfig().to_dict(), completed=("profile",),
          stats={"conv1": stats}, luts={"conv1": bf},
          opt_state=({"m": jnp.ones(3)}, jnp.zeros((), jnp.int32))
          ).save(tmp_path / "a")

    port = TPlan.load(tmp_path / "a")
    rec = port.stats["conv1"]
    assert isinstance(rec, TLayerStats) and rec.n_transitions == 1234
    assert port.luts["conv1"].dtype == torch.bfloat16
    assert isinstance(port.opt_state, tuple)
    port.save(tmp_path / "b")

    back = JPlan.load(tmp_path / "b")
    s2 = back.stats["conv1"]
    assert isinstance(s2, LayerStats) and s2.n_transitions == 1234
    for f in ("act_hist", "group_hist", "energy_sum", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(s2, f)),
                                      np.asarray(getattr(stats, f)))
    assert back.luts["conv1"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back.luts["conv1"]),
                                  np.asarray(bf))
    assert back.completed == ("profile",)
    JConfig.from_dict(back.config)


class _WorkStarted(Exception):
    pass


def test_default_config_and_every_target_start_work():
    """The default config (``search_mode="batched"``) starts work. A dense
    LM target builds, and so do the routed targets (moe, scan); the cosim
    gate's run starts work too. An LM pipeline's stages run through serve
    (the engine is not run here)."""
    pipe = TPipeline(TConfig(), device="cpu")     # search_mode="batched"
    assert pipe.cfg.schedule.search_mode == "batched"

    def init():
        raise _WorkStarted

    pipe.target.runner.init = init
    with pytest.raises(_WorkStarted):
        pipe.run()
    assert not pipe.plan.completed
    lm = TConfig.from_dict({"target": {"kind": "lm", "arch": "olmo-1b",
                                       "reduced": True},
                            "train": {"qat_steps": 0}})
    lm_pipe = TPipeline(lm, device="cpu")
    assert lm_pipe.target.kind == "lm"
    for kind, arch in (("moe", "phi3.5-moe-42b-a6.6b"),
                       ("scan", "mamba2-1.3b")):
        routed = TConfig.from_dict({"target": {"kind": kind, "arch": arch,
                                               "reduced": True}})
        routed_pipe = TPipeline(routed, device="cpu")
        assert routed_pipe.target.kind == kind
        assert type(routed_pipe.target).__name__ == \
            {"moe": "MoETarget", "scan": "ScanTarget"}[kind]
        assert not routed_pipe.plan.completed
    cosim = TPipeline(TConfig.from_dict({"profile": {"verify_cosim": True}}),
                      device="cpu")
    cosim.target.runner.init = init
    with pytest.raises(_WorkStarted):
        cosim.run()
    assert not cosim.plan.completed
    assert "serve" in lm_pipe.STAGES
    assert not lm_pipe.plan.completed
