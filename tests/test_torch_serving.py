"""The port's serving engine on the CPU (reduced olmo-1b, float32): bucketing
and `EngineConfig` validation, the three scheduling modes against each
other and against the reference `generate`, chunked prefill against a full
prefill, FIFO admission, the no-builds-after-warmup contract, the steps'
shape checks, seeded sampling, the padded-work accounting, the deprecated
call forms, and the launcher and pipeline entry points.

The trace and engine config are the JAX package's serving tests'
(``tests/test_serving_engine.py``); every draw comes from a seeded
`np.random.default_rng` or `torch.Generator`.

Exactness: every mode must give the same tokens — uncompressed, on the
k = 4 fake-quant forward and on the packed LUT GEMM. Each row's result is a
function of that row alone: the engine's forward is
``QuantConfig.batch_invariant`` (products and sums round once from float64
sums, and a compressed plan's activation fake-quant takes one scale a
token position), so chunked prefill equals a full prefill bit for bit and
tokens are compared for equality.
"""

import dataclasses
import warnings

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.fake_quant import fake_quant as k3
from repro_torch.kernels.lut_matmul import lut_matmul as k2
from repro_torch.models.lm import build_lm
from repro_torch.nn.layers import QuantConfig
from repro_torch.nn.spec import init_params
from repro_torch.serving import (
    EngineConfig,
    PlanHandle,
    RequestStats,
    ServeRequest,
    ServingEngine,
    bucket_for,
    bucket_up,
    chunk_plan,
    pad_prompts,
    percentile,
)

CFG = EngineConfig(max_batch=4, prompt_buckets=(8, 16),
                   new_token_buckets=(8,), max_waves=2)
LUT_CFG = dataclasses.replace(CFG, lut_serve=True)

# (prompt_len, new_tokens) mixed-length trace over both prompt buckets,
# with early-finishing requests inside a wave
TRACE = [(6, 8), (8, 5), (14, 8), (5, 8), (8, 8), (16, 6), (12, 8)]
NEWS = [n for _, n in TRACE]
MODES = ("engine", "wave", "oneshot")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work in this file runs on one thread: beside the
    suite's parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    cfg = get_config("olmo-1b").scaled_down(compute_dtype="float32")
    model = build_lm(cfg)
    return model, init_params(0, model.spec, "cpu")


@pytest.fixture(scope="module")
def prompts(lm):
    model, _ = lm
    rng = np.random.default_rng(3)
    return [rng.integers(0, model.cfg.vocab, size=plen).astype(np.int32)
            for plen, _ in TRACE]


@pytest.fixture(scope="module")
def k4(lm):
    model, _ = lm
    return PlanHandle.from_compress_k(model, 4, device="cpu")


def engine(lm, mode, config=CFG, plan=None, shapes=TRACE):
    model, params = lm
    e = ServingEngine(model, params, mode=mode, config=config, plan=plan,
                      device="cpu")
    e.warmup(shapes)
    return e


def serve(e, prompts, news=NEWS, **kw):
    """Tokens of each request, in submission order."""
    reqs = [ServeRequest(tokens=p, max_new_tokens=n, **kw)
            for p, n in zip(prompts, news)]
    return [r.tokens for r in e.serve(reqs)]


@pytest.fixture(scope="module")
def engines(lm):
    return {mode: engine(lm, mode) for mode in ("engine", "oneshot")}


# ------------------------------------------------------------- pure helpers


def test_bucket_up_and_bucket_for():
    assert bucket_up(5, (8, 16)) == 8
    assert bucket_up(8, (8, 16)) == 8
    assert bucket_up(9, (8, 16)) == 16
    with pytest.raises(ValueError):
        bucket_up(17, (8, 16))
    b = bucket_for(5, 6, CFG, batch=4)
    assert (b.batch, b.prompt_len, b.total_len) == (4, 8, 16)
    assert b.new_tokens == 8 and b.key() == (4, 8, 16)
    with pytest.raises(ValueError):
        bucket_for(0, 6, CFG, batch=4)


def test_pad_prompts():
    b = bucket_for(5, 6, CFG, batch=4)
    out = pad_prompts([[1, 2, 3], [4, 5, 6, 7, 8]], b, pad_token=0)
    assert out.shape == (4, 8) and out.dtype == np.int32
    assert list(out[0]) == [1, 2, 3, 0, 0, 0, 0, 0]
    assert list(out[1]) == [4, 5, 6, 7, 8, 0, 0, 0]
    assert not out[2:].any()          # dummy rows are all-pad
    with pytest.raises(ValueError):
        pad_prompts([[1]] * 5, b, pad_token=0)      # too many rows
    with pytest.raises(ValueError):
        pad_prompts([list(range(9))], b, pad_token=0)  # prompt too long


def test_percentile():
    assert percentile([], 50) == 0.0
    assert percentile([3.0], 99) == 3.0
    xs = [1.0, 2.0, 3.0, 4.0]
    assert percentile(xs, 0) == 1.0
    assert percentile(xs, 100) == 4.0
    assert percentile(xs, 50) == pytest.approx(2.5)
    assert percentile([4.0, 1.0, 3.0, 2.0], 50) == pytest.approx(2.5)


@pytest.mark.parametrize("bad", [
    dict(max_batch=0), dict(max_waves=0), dict(q_block=0), dict(kv_block=-1),
    dict(chunk_rows=-1), dict(prompt_buckets=()), dict(prompt_buckets=(8, 8)),
    dict(prompt_buckets=(8, 0)), dict(prompt_buckets=[8, 16]),
    dict(new_token_buckets=(True,)),
    dict(prompt_buckets=(8,), chunk_buckets=(5,)),
    dict(lut_serve=1), dict(lut_use_ref="yes"), dict(autotune_cache=3),
    dict(cache_dtype="int8"),
])
def test_engine_config_validation(bad):
    with pytest.raises(ValueError):
        EngineConfig(**bad)


def test_engine_config_derived_values():
    cfg = EngineConfig(max_batch=4, prompt_buckets=(8, 16),
                       new_token_buckets=(8,))
    assert cfg.resolved_chunk_buckets == (8,)        # gcd of prompt buckets
    assert cfg.chunk_row_buckets == (1, 2)
    assert cfg.group_total_len == 24 and cfg.slot_capacity == 8
    assert cfg.torch_cache_dtype == torch.float32
    assert EngineConfig(cache_dtype="bfloat16").torch_cache_dtype \
        == torch.bfloat16
    assert EngineConfig(lut_use_ref=True).lut_use_ref is True
    assert chunk_plan(32, (16,)) == (16, 16)
    assert chunk_plan(24, (16, 8)) == (16, 8)
    with pytest.raises(ValueError):
        chunk_plan(12, (16, 8))                      # greedy remainder 4
    # K2's tuner cache: a path string is taken, anything else refused
    assert EngineConfig(autotune_cache="tune.json").autotune_cache \
        == "tune.json"
    with pytest.raises(ValueError, match="autotune_cache"):
        EngineConfig(autotune_cache=Path("tune.json"))


def test_request_stats_guard_unset_timestamps():
    s = RequestStats(rid=0, prompt_len=4, new_tokens=4, bucket=(),
                     t_submit=123.0)
    with pytest.raises(ValueError, match="latency"):
        s.latency_s
    with pytest.raises(ValueError, match="first token"):
        s.ttft_s
    s.t_first_token, s.t_finish = 124.0, 125.0
    assert s.ttft_s == pytest.approx(1.0)
    assert s.latency_s == pytest.approx(2.0)


@pytest.mark.parametrize("variant", ["uncompressed", "k4_fake_quant",
                                     "k4_lut"])
def test_engine_forward_is_batch_invariant(lm, k4, variant):
    """The engine serves every plan with ``batch_invariant`` set; every
    other forward of the port keeps the JAX package's numerics."""
    plan = None if variant == "uncompressed" else k4
    config = LUT_CFG if variant == "k4_lut" else CFG
    model, params = lm
    qcfg = ServingEngine(model, params, config=config, plan=plan,
                         device="cpu").qcfg
    assert qcfg.batch_invariant
    assert qcfg.enabled is (plan is not None)
    assert qcfg.comp_mode == ("serve" if variant == "k4_lut"
                              else "fake_quant")
    for default in (QuantConfig(), QuantConfig.on(), QuantConfig.serve()):
        assert not default.batch_invariant


# -------------------------------------------------------------- the modes


@pytest.mark.parametrize("variant", ["uncompressed", "k4_fake_quant",
                                     "k4_lut"])
def test_modes_agree_on_mixed_trace(lm, prompts, k4, variant):
    """engine == wave == oneshot, token for token, on the mixed trace: the
    slot scheduler changes when work runs, never what a request computes,
    also on a compressed plan (fake-quant: one K3 call a step; LUT: the
    packed artifacts on K2's plain version)."""
    plan = None if variant == "uncompressed" else k4
    config = LUT_CFG if variant == "k4_lut" else CFG
    out = {mode: serve(engine(lm, mode, config, plan), prompts)
           for mode in MODES}
    assert [len(t) for t in out["engine"]] == NEWS
    assert out["engine"] == out["wave"] == out["oneshot"]


def test_per_call_activation_scale_couples_rows(lm, prompts, k4):
    """Why the engine's forward is batch-invariant: with the JAX package's
    one activation scale a call, a row's logits depend on the rows beside
    it; with one scale a token position they do not."""
    model, params = lm
    toks = torch.tensor(np.stack([prompts[1], prompts[4]]))
    for invariant in (False, True):
        qcfg = QuantConfig(enabled=True, batch_invariant=invariant)
        pair, _ = model.forward(params, toks, qcfg=qcfg, comp=k4.comp,
                                q_block=8, kv_block=8)
        alone, _ = model.forward(params, toks[:1], qcfg=qcfg, comp=k4.comp,
                                 q_block=8, kv_block=8)
        assert torch.equal(pair[:1], alone) is invariant, invariant


def test_exact_fit_matches_reference_generate(lm, engines, prompts):
    """A prompt that fills its bucket reproduces `launch.serve.generate`
    token for token (uncompressed, greedy)."""
    from repro_torch.launch.serve import generate

    model, params = lm
    prompt = prompts[1][:8]                     # exact bucket fit (8 -> 8)
    got = serve(engines["oneshot"], [prompt], [8])[0]
    want = generate(model, params, torch.tensor(prompt)[None], new_tokens=8)
    assert got == want[0].tolist()
    assert serve(engines["engine"], [prompt], [8])[0] == got


@pytest.mark.parametrize("variant", ["uncompressed", "k4_fake_quant",
                                     "k4_lut"])
def test_chunked_prefill_matches_full_prefill(lm, prompts, k4, variant):
    """Prefilling 16 tokens as two 8-token chunks against a live float32
    cache gives the logits and cache of one full prefill, bit for bit."""
    from repro_torch.core.lm_compress import attach_serve_artifacts

    model, params = lm
    comp, qcfg = None, QuantConfig(batch_invariant=True)
    if variant != "uncompressed":
        comp, qcfg = k4.comp, QuantConfig(enabled=True, batch_invariant=True)
    if variant == "k4_lut":
        comp, _ = attach_serve_artifacts(model, params, k4.comp)
        qcfg = dataclasses.replace(QuantConfig.serve(), batch_invariant=True)
    toks = torch.tensor(np.stack([np.resize(prompts[2], 16),
                                  np.resize(prompts[6], 16)]))
    kw = dict(qcfg=qcfg, comp=comp)
    with torch.no_grad():
        full, full_cache = model.prefill(params, toks, 24,
                                         cache_dtype=torch.float32,
                                         q_block=8, kv_block=8, **kw)
        cache = model.init_cache(2, 24, torch.float32, device="cpu")
        z = torch.zeros(2, dtype=torch.int32)
        l1, cache = model.prefill_chunk(params, cache, toks[:, :8], start=z,
                                        **kw)
        l2, cache = model.prefill_chunk(params, cache, toks[:, 8:],
                                        start=z + 8, **kw)
    assert cache["pos"].tolist() == [16, 16]
    assert torch.equal(l1, full[:, :8]) and torch.equal(l2, full[:, 8:])
    for key in ("k", "v"):
        assert torch.equal(cache["groups"]["g0"][key],
                           full_cache["groups"]["g0"][key])


def test_slot_admission_is_fifo(lm, prompts):
    """With 2 slots and 6 alternating-bucket requests, ``t_admitted``
    follows submit order."""
    cfg = EngineConfig(max_batch=2, prompt_buckets=(8, 16),
                       new_token_buckets=(8,), max_waves=1)
    e = engine(lm, "engine", cfg, shapes=[(16, 8), (8, 8)])
    rids = [e.submit(prompts[2] if i % 2 == 0 else prompts[1][:8], 8)
            for i in range(6)]
    res = e.run()
    admitted = [res[r].stats.t_admitted for r in rids]
    assert all(a is not None for a in admitted)
    assert admitted == sorted(admitted)


def test_wave_packing_partial_and_multi_wave(lm, prompts):
    """5 same-bucket requests at width 4: one full and one partial wave,
    one bucket built."""
    e = engine(lm, "wave", shapes=[(8, 8)])
    out = serve(e, [p[:7] for p in prompts[:5]], [8] * 5)
    assert len(out) == 5 and all(len(t) == 8 for t in out)
    rep = e.report()
    assert rep["requests"] == 5 and rep["cache_buckets_compiled"] == 1


# ------------------------------------------------------------- the steps


def test_zero_builds_after_warmup(engines, prompts):
    for e in engines.values():
        before = e.cache.compile_count
        assert before > 0
        serve(e, prompts)
        serve(e, prompts[::-1], NEWS[::-1])
        assert e.cache.compile_count == before, e.mode


def test_steps_reject_other_shapes(lm, engines):
    """A step built for one shape raises `TypeError` at any other, instead
    of quietly building a new one."""
    model, params = lm
    one, eng = engines["oneshot"], engines["engine"]
    built = one.cache.compile_count + eng.cache.compile_count
    fns = one.cache.fns(bucket_for(6, 8, CFG, batch=1), params)
    z = torch.zeros
    with pytest.raises(TypeError):
        fns.prefill(params, z((2, 8), dtype=torch.int32))     # wrong batch
    with pytest.raises(TypeError):
        fns.prefill(params, z((1, 12), dtype=torch.int32))    # wrong length
    with pytest.raises(TypeError):
        fns.prefill(params, z((1, 8), dtype=torch.int64))     # wrong dtype
    group = eng.cache.group_fns(params)
    cache = group.make_cache()
    with pytest.raises(TypeError):
        group.decode(params, cache, z((2, 1), dtype=torch.int32),
                     z((2,), dtype=torch.bool))
    chunk = eng.cache.chunk_fns(8, 1, params)
    with pytest.raises(TypeError):
        chunk.fn(params, cache, z((1, 16), dtype=torch.int32),
                 *(z((1,), dtype=torch.int32),) * 2,
                 z((1,), dtype=torch.bool))
    assert one.cache.compile_count + eng.cache.compile_count == built


def test_forward_calls_make_one_k3_launch_each(lm, prompts, k4,
                                               monkeypatch):
    """The fake-quant engine makes one grouped K3 call a forward (chunk
    step or decode step); the LUT engine none, and 7 K2 calls a layer."""
    from repro_torch.core import export, qat

    model, _ = lm
    calls = {"k3": 0, "k2": 0, "forwards": 0}
    real_fq, real_k2 = qat.fake_quant_weights, export.lut_matmul_fused

    def fq(*a, **kw):
        calls["k3"] += 1
        return real_fq(*a, **kw)

    def lut(*a, **kw):
        calls["k2"] += 1
        return real_k2(*a, **kw)

    monkeypatch.setattr(qat, "fake_quant_weights", fq)
    monkeypatch.setattr(export, "lut_matmul_fused", lut)
    for name in ("prefill_chunk", "decode_step"):
        real = getattr(model, name)

        def counted(*a, _real=real, **kw):
            calls["forwards"] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(model, name, counted)
    for config, want in ((CFG, (1, 0)), (LUT_CFG, (0, 7 * 2))):
        calls.update(k3=0, k2=0, forwards=0)
        serve(engine(lm, "engine", config, k4), prompts)
        assert (calls["k3"], calls["k2"]) == (
            want[0] * calls["forwards"], want[1] * calls["forwards"])
    assert k2.launches == 0 and k3.launches == 0     # no card here


@pytest.mark.parametrize("mode", ["engine", "oneshot"])
def test_temperature_sampling_parity(engines, prompts, mode):
    """Seeded host-side sampling is a function of the request's seed: each
    mode's draws equal the engine's, and they differ from greedy."""
    eng = engines["engine"]
    picks = [prompts[i] for i in (0, 1, 3)]
    want = serve(eng, picks, [6] * 3, temperature=0.7, seed=11)
    assert serve(engines[mode], picks, [6] * 3, temperature=0.7,
                 seed=11) == want
    assert want != serve(eng, picks, [6] * 3)


def test_submit_rejects_unbucketable(engines):
    e = engines["engine"]
    with pytest.raises(ValueError):
        e.submit(np.zeros(17, np.int32), 8)   # prompt > largest bucket
    with pytest.raises(ValueError):
        e.submit(np.zeros(8, np.int32), 9)    # new_tokens > largest bucket


def test_engine_rejects_unknown_mode_and_mesh(lm):
    model, params = lm
    with pytest.raises(ValueError, match="mode"):
        ServingEngine(model, params, mode="waves", config=CFG, device="cpu")
    with pytest.raises(TypeError, match="LocalMesh"):
        ServingEngine(model, params, config=CFG, mesh=object(), device="cpu")


@pytest.mark.parametrize("entry", ["engine", "step_cache"])
def test_entry_points_default_to_the_card(lm, entry):
    """Built without ``device=``, the engine and its step cache ask for
    CUDA, as every entry point of the port does."""
    from repro_torch.serving import ServeCompileCache

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal cannot be shown here")
    model, params = lm
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "engine":
            ServingEngine(model, params, config=CFG)
        else:
            ServeCompileCache(model, arch=model.cfg.name)


def test_lut_serve_needs_a_compressed_plan(lm):
    model, params = lm
    e = ServingEngine(model, params, config=LUT_CFG, device="cpu")
    assert e.serve_units == 0 and not e.qcfg.enabled   # uncompressed
    handle = PlanHandle.from_compress_k(model, 32, device="cpu")
    with pytest.raises(ValueError, match="servable"):
        ServingEngine(model, params, config=LUT_CFG, plan=handle,
                      device="cpu")


# -------------------------------------------------------------- accounting


def test_padded_work_accounting(lm, prompts):
    """A 6-token prompt in an 8-bucket at batch 1 executes 8 prefill + 7
    decode positions but is charged 6 + 8 tokens."""
    one = engine(lm, "oneshot", shapes=[(6, 8)])
    serve(one, [prompts[0][:6]], [8])
    rep = one.report()
    e_tok = one.per_token_energy_eu
    assert rep["executed_positions"] == 8 + 7
    assert rep["slot_utilization"] == pytest.approx(14 / 15)
    assert rep["energy_eu_overhead"] == pytest.approx(e_tok * 1)
    assert rep["energy_eu_total"] == pytest.approx(e_tok * 14)


def test_engine_accounting_and_report(lm, prompts):
    """Slot mode charges chunk rows x chunk and the group width a decode
    step; the report carries every key the serve stage records."""
    e = engine(lm, "engine")
    serve(e, prompts[:2], [8, 5])           # 6 -> 8 and 8 -> 8 prompts
    rep = e.report()
    # one 2-row chunk step of 8, then decode steps over the 4-row group
    # until the 8-token request ends (7 more steps after the first token)
    assert rep["executed_positions"] == 2 * 8 + 7 * 4
    assert rep["slot_utilization"] == pytest.approx((6 + 8 + 8 + 5) / 44)
    assert rep["energy_eu_overhead"] == pytest.approx(
        e.per_token_energy_eu * (44 - 27))
    for key in ("requests", "tokens_per_s", "latency_p50_s", "latency_p99_s",
                "ttft_p50_s", "ttft_p99_s", "energy_eu_total",
                "executed_positions", "slot_utilization",
                "energy_eu_overhead", "cache_compile_count",
                "cache_buckets_compiled"):
        assert key in rep, key
    stats = e.result(0).stats
    assert stats.energy_eu == pytest.approx(e.per_token_energy_eu * (6 + 8))
    assert stats.latency_s >= stats.ttft_s >= 0.0


def test_compressed_artifacts_and_fingerprint(lm, k4):
    model, params = lm
    e = ServingEngine(model, params, config=CFG, plan=k4, device="cpu")
    arts, summary = e.artifacts()
    assert summary["layers"] == len(arts) == 14
    assert summary["weight_bytes_packed"] > 0
    assert e.cache.stats()["fingerprint"] == k4.fingerprint
    assert k4.fingerprint != PlanHandle.uncompressed().fingerprint
    lut = ServingEngine(model, params, config=LUT_CFG, plan=k4, device="cpu")
    assert lut.serve_units == 7 and lut.cache.fingerprint == k4.fingerprint


# ------------------------------------------------------ deprecated forms


def test_deprecated_call_forms_warn(lm, prompts, engines):
    model, params = lm
    with pytest.warns(DeprecationWarning, match="compress_k"):
        old = ServingEngine(model, params, config=CFG, compress_k=4,
                            device="cpu")
    assert old.compress_k == 4 and old.plan.plan_id == "k4"
    with pytest.raises(ValueError, match="not both"):
        ServingEngine(model, params, config=CFG, compress_k=4,
                      plan=PlanHandle.uncompressed(), device="cpu")
    e = engines["engine"]
    with pytest.warns(DeprecationWarning, match="ServeRequest"):
        res = e.serve(prompts[:2], 4)
    assert sorted(res) == list(res) and all(len(r.tokens) == 4
                                            for r in res.values())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="new_tokens"):
            e.serve(prompts[:3], [8, 8])


# ------------------------------------------------------- entry points


def test_pipeline_serve_stage_on_the_cpu():
    """`Pipeline(cfg, device="cpu")` runs the LM target's five stages, the
    serve stage through the engine and the oneshot fallback."""
    from repro_torch.pipeline.config import reduced_lm_config
    from repro_torch.pipeline.pipeline import Pipeline

    cfg = reduced_lm_config("olmo-1b", verify_oneshot=True)
    pipe = Pipeline(cfg, device="cpu")
    m = pipe.run().metrics
    assert pipe.plan.completed[-1] == "serve"
    assert m["serve_requests"] == 2 and m["serve_new_tokens"] == 6 + 3
    assert m["serve_recompiles_after_warmup"] == 0
    assert m["serve_parity_engine_vs_oneshot"] is True
    assert len(pipe.target.last_serve_results) == 2


def test_launch_serve_main(capsys):
    from repro_torch.launch.serve import main, trace_shapes

    assert trace_shapes(3, 12, 6, True) == [(12, 6), (5, 3), (2, 6)]
    assert main(["--reduced", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "8", "--new-tokens", "4",
                 "--compress-k", "4"]) == 0
    out = capsys.readouterr().out
    assert "compressed export: 14 matmuls" in out and "engine: 2 requests" \
        in out
