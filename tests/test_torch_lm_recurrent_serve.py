"""Port parity for the recurrent LM families beyond the forward: the LM
target's profile → export on the reduced mamba2-1.3b and
recurrentgemma-2b (the export of the JAX package's schedule plan
byte-identical), the serving engine's recurrent single-chunk rule, the
engine against the oneshot fallback and against JAX's engine on prompts
shorter than their bucket, and the entry points (compress, serve, train)
on both families.

Tolerances and why:
  * comp trees and exported artifacts: equal (integer encodes of identical
    floats); unit shares: rel 1e-5 (float32 sums of the same integer
    counts against the same LUT);
  * `lut_parity_report`: < 1e-6 (served and fake-quant products both
    correctly rounded);
  * greedy tokens: equal (engine == oneshot is the engine's contract; the
    port's uncompressed engine against JAX's, whose logits agree to ~1e-7
    relative: no greedy choice on these draws is that close).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.lm import build_lm as jbuild
from repro.nn.spec import init_params as jinit
from repro.pipeline.config import reduced_lm_config as j_reduced_lm
from repro.pipeline.pipeline import Pipeline as JPipeline
from repro.pipeline.plan import CompressionPlan as JPlan
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeRequest as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.core import lm_compress as tlc
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn.spec import params_from_numpy
from repro_torch.pipeline import targets as ttargets
from repro_torch.pipeline.pipeline import Pipeline as TPipeline
from repro_torch.pipeline.plan import CompressionPlan as TPlan
from repro_torch.serving import EngineConfig, PlanHandle, ServeRequest
from repro_torch.serving import ServingEngine

ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")
ART_FIELDS = ("packed", "codebook", "scale")
ART_META = ("k_dim", "n_dim", "block_k", "kind", "kernel")
CFG = dict(max_batch=4, prompt_buckets=(8, 16), new_token_buckets=(6,),
           max_waves=2)


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


# ------------------------------------------------------------------ export


@pytest.fixture(scope="module", params=ARCHS)
def plans(request, tmp_path_factory):
    """The JAX package's reduced pipeline on one family, its schedule and
    export plans saved, and the port resuming the schedule plan through
    export (priced with the JAX package's uniform-trace LUT: the two
    packages' Monte-Carlo draws differ)."""
    arch = request.param
    base = tmp_path_factory.mktemp(arch)
    pipe = JPipeline(j_reduced_lm(arch))
    pipe.run_until("schedule")
    pipe.plan.save(base / "schedule")
    pipe.run_until("export")
    pipe.plan.save(base / "export")
    lut = torch.from_numpy(np.array(JPlan.load(base / "export")
                                    .luts["uniform"]))
    real = ttargets.uniform_trace_lut
    ttargets.uniform_trace_lut = lambda device="cpu": lut.to(device)
    try:
        port = TPipeline.from_plan(TPlan.load(base / "schedule"),
                                   device="cpu").run_until("export")
    finally:
        ttargets.uniform_trace_lut = real
    return dict(arch=arch, want=JPlan.load(base / "export"), got=port,
                jm=pipe.target.model)


def test_export_of_jax_schedule_plan_is_byte_identical(plans):
    got, want = plans["got"], plans["want"]
    n_units = {"mamba2-1.3b": 2 * 2, "recurrentgemma-2b": 2 * 23}
    assert list(got.artifacts) == list(want.artifacts)
    assert len(got.artifacts) == n_units[plans["arch"]]
    for name, art in want.artifacts.items():
        for f in ART_FIELDS:
            np.testing.assert_array_equal(t2n(getattr(got.artifacts[name],
                                                      f)),
                                          np.asarray(getattr(art, f)),
                                          err_msg=f"{name}.{f}")
        for f in ART_META:
            assert getattr(got.artifacts[name], f) == getattr(art, f)
    assert got.stats["export"]["skip_report"] == \
        want.stats["export"]["skip_report"] == []
    for key in ("export_layers", "export_weight_bytes_packed",
                "export_weight_bytes_dense_int8"):
        assert got.metrics[key] == want.metrics[key], key
    assert got.metrics["export_parity_max_rel_err"] < 1e-6


def test_unit_names_and_shares_match_jax(plans):
    """The recurrent units' slice names (``blocks/g0/ssm/in_proj[1]``) in
    the energy shares and decisions, in the JAX package's order."""
    got, want = plans["got"], plans["want"]
    assert list(got.shares) == list(want.shares)
    np.testing.assert_allclose(list(got.shares.values()),
                               list(want.shares.values()), rtol=1e-5)
    names = [d["layer"] for d in got.decisions]
    assert names == [d["layer"] for d in want.decisions]
    mixer = "ssm" if plans["arch"] == "mamba2-1.3b" else "rglru"
    assert f"blocks/g0/{mixer}/in_proj[1]" in got.artifacts
    assert f"blocks/g0/{mixer}/in_proj[1]" in names


def test_lut_parity_report_covers_the_recurrent_units(plans):
    got = plans["got"]
    model = TPipeline.from_plan(got, device="cpu").target.model
    checked = tlc.lut_parity_report(model, got.params, got.comp,
                                    got.artifacts,
                                    check_units=len(got.artifacts))
    assert list(checked) == list(got.artifacts)
    assert max(checked.values()) < 1e-6


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def lms():
    """{arch: (JAX model, JAX params, port model, port params)}, the
    reduced models in float32."""
    out = {}
    for arch in ARCHS:
        jm = jbuild(jget(arch).scaled_down(compute_dtype="float32"))
        jp = jinit(jax.random.PRNGKey(0), jm.spec)
        tm = tbuild(tget(arch).scaled_down(compute_dtype="float32"))
        out[arch] = (jm, jp, tm, params_from_numpy(jax.device_get(jp),
                                                   "cpu"))
    return out


def requests(vocab, lens=(9, 16, 5, 12, 16)):
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch", ARCHS)
def test_single_chunk_rule_raises_as_jax(lms, arch):
    """Chunk buckets that split a prompt bucket are refused for a recurrent
    mixer by both packages; without chunk buckets each prompt bucket is
    one chunk."""
    jm, jp, tm, tp = lms[arch]
    split = dict(CFG, chunk_buckets=(8,))
    with pytest.raises(ValueError, match="single-chunk plan") as jerr:
        JEngine(jm, jp, config=JEngineConfig(**split))
    with pytest.raises(ValueError, match="single-chunk plan") as terr:
        ServingEngine(tm, tp, config=EngineConfig(**split), device="cpu")
    assert str(terr.value) == str(jerr.value)
    engine = ServingEngine(tm, tp, config=EngineConfig(**CFG), device="cpu")
    assert engine._chunk_sizes() == {8, 16}
    assert engine._chunk_plan(16) == (16,)
    whole = ServingEngine(tm, tp, config=EngineConfig(
        **dict(CFG, chunk_buckets=(8, 16))), device="cpu")
    assert whole._chunk_plan(16) == (16,)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_equals_oneshot_on_a_k4_plan(lms, arch):
    """Prompts shorter than their bucket (9 and 5 and 12 of buckets 16
    and 8), padded with ``pad_token`` at the end: the recurrent state
    absorbs the padded positions in every mode (JAX's bucket contract),
    and the engine's single-chunk prefill gives the oneshot fallback's
    tokens, on the k = 4 fake-quant forward."""
    jm, jp, tm, tp = lms[arch]
    comp = tlc.restrict_all_codebooks(tm, tlc.init_lm_comp(tm, device="cpu"),
                                      tlc.symmetric_codebook_values(4))
    handle = PlanHandle.from_comp(comp, compress_k=4, plan_id="k4")
    reqs = [ServeRequest(tokens=p, max_new_tokens=6)
            for p in requests(tm.cfg.vocab)]
    out = {}
    for mode in ("engine", "oneshot"):
        engine = ServingEngine(tm, tp, mode=mode, config=EngineConfig(**CFG),
                               plan=handle, device="cpu")
        engine.warmup([(16, 6), (8, 6)])
        built = engine.cache.compile_count
        out[mode] = [r.tokens for r in engine.serve(reqs)]
        assert engine.cache.compile_count == built
    assert out["engine"] == out["oneshot"]
    assert all(len(t) == 6 for t in out["engine"])


def test_engine_tokens_match_jax_engine(lms):
    """The port's uncompressed engine against JAX's on reduced mamba2, the
    same prompts (some shorter than their bucket) and slot config: greedy
    tokens equal."""
    jm, jp, tm, tp = lms["mamba2-1.3b"]
    prompts = requests(tm.cfg.vocab)
    jengine = JEngine(jm, jp, config=JEngineConfig(**CFG))
    want = [r.tokens for r in jengine.serve(
        [JRequest(tokens=p, max_new_tokens=6) for p in prompts])]
    engine = ServingEngine(tm, tp, config=EngineConfig(**CFG), device="cpu")
    got = [r.tokens for r in engine.serve(
        [ServeRequest(tokens=p, max_new_tokens=6) for p in prompts])]
    assert got == want


# ------------------------------------------------------------ entry points


@pytest.mark.parametrize("arch", ARCHS)
def test_compress_cli_runs_the_family(arch, tmp_path, capsys):
    """``python -m repro_torch compress --target lm --arch <family>``
    (reduced, one QAT step) runs through export; the saved plan serves
    through ``serve --plan-in`` (engine checked against oneshot)."""
    from repro_torch.pipeline import cli

    assert cli.main(["compress", "--target", "lm", "--arch", arch,
                     "--reduced", "--steps", "1", "--compress-k", "4",
                     "--device", "cpu", "--quiet",
                     "--plan-out", str(tmp_path / "plan")]) == 0
    plan = TPlan.load(tmp_path / "plan")
    assert plan.completed[-1] == "export" and plan.metrics["export_layers"]
    assert cli.main(["serve", "--plan-in", str(tmp_path / "plan"),
                     "--device", "cpu", "--verify-oneshot", "--quiet",
                     "--plan-out", str(tmp_path / "served")]) == 0
    m = TPlan.load(tmp_path / "served").metrics
    assert m["serve_parity_engine_vs_oneshot"] is True
    assert m["serve_recompiles_after_warmup"] == 0
    capsys.readouterr()


@pytest.mark.parametrize("arch,n_units", [("whisper-large-v3", 16),
                                          ("internvl2-26b", 7)])
def test_encdec_and_vlm_compress_through_export(arch, n_units, tmp_path,
                                                capsys):
    """The encoder-decoder (whisper) and the VLM prefix (internvl2) compress
    through export (the prefix is held to JAX's in
    `tests/test_torch_lm_vlm.py`)."""
    from repro_torch.pipeline import cli

    argv = ["compress", "--target", "lm", "--arch", arch, "--reduced",
            "--device", "cpu"]
    assert cli.main(argv + ["--quiet", "--plan-out",
                            str(tmp_path / "plan")]) == 0
    plan = TPlan.load(tmp_path / "plan")
    assert plan.completed[-1] == "export"
    assert plan.metrics["n_units"] == n_units
    capsys.readouterr()


def test_train_and_serve_launchers_run_the_families(capsys):
    """`repro_torch.launch.train` (2 QAT steps, finite losses) on reduced
    mamba2 and `repro_torch.launch.serve` (k = 4) on reduced
    recurrentgemma."""
    from repro_torch.launch import serve, train
    from repro_torch.pipeline.targets import LMTarget

    real = LMTarget._qat_train
    losses = []

    def recorded(self, *a, **kw):
        out = real(self, *a, **kw)
        losses.extend(self.last_qat["loss"])
        return out

    LMTarget._qat_train = recorded
    try:
        assert train.main(["--arch", "mamba2-1.3b", "--reduced", "--steps",
                           "2", "--batch-size", "2", "--device",
                           "cpu"]) == 0
    finally:
        LMTarget._qat_train = real
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert serve.main(["--arch", "recurrentgemma-2b", "--reduced",
                       "--compress-k", "4", "--batch", "2", "--prompt-len",
                       "10", "--new-tokens", "4", "--device", "cpu"]) == 0
    assert "engine: 2 requests" in capsys.readouterr().out
