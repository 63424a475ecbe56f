"""The port's serving pieces against the JAX package on the same numpy
arrays (reduced olmo-1b: 2 layers, d 128, GQA; float32): chunked prefill on
a partly filled group cache, the cache row gather/scatter, masked group
decode (each uncompressed and on the k = 4 fake-quant forward), the
engine's batch-invariant forward where its activation scales coincide with
JAX's, plan fingerprints, the per-token serving energy, the engine against
JAX's reference `generate`, and the port's ``serve --plan-in`` on a plan the
JAX package wrote.

No JAX `ServingEngine` is built here (its ahead-of-time compiles cost
minutes). Nothing here relies on JAX's engine agreeing with its own
oneshot fallback on a compressed plan: with one activation scale a call it
need not (`tests/test_torch_serving.py::
test_per_call_activation_scale_couples_rows`). The port's engine departs
from JAX there by design (``QuantConfig.batch_invariant``: one scale a
token position); where one token is the whole call (batch-1 decode) the
two scales are the same number, and the two forwards must agree.

Tolerances and why:
  * ``prefill_chunk`` logits and caches, ``decode_step(active)``: rel 1e-5,
    the bound of the other LM parity tests (both packages run the same
    float32 operations; only summation orders differ);
  * the batch-invariant batch-1 decode: each quantized activation equal to
    JAX's quantization of it; logits rel 2e-2, the README's
    ``serve_forward_parity`` bound for two forwards that differ only in
    roundings at a quantizer (a correctly rounded attention score and
    JAX's float32 one can put an activation on two sides of an int8
    rounding midpoint, one level apart);
  * cache row gather/scatter, fingerprints, positions: equal (data
    movement and hashing);
  * ``per_token_energy`` on the JAX package's LUT: rel 1e-6 (integer
    weight histograms against the same float32 LUT, summed in float32 in
    the same order);
  * greedy tokens of exact-fit prompts: equal.
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

from repro.configs import get_config as jget
from repro.core import energy_lut as jelut
from repro.core import qat as jqat
from repro.core import lm_compress as jlc
from repro.launch.serve import generate as jgenerate
from repro.models.lm import build_lm as jbuild
from repro.nn.layers import QuantConfig as JQ
from repro.nn.spec import init_params as jinit
from repro.pipeline.config import reduced_lm_config as j_reduced_lm
from repro.pipeline.pipeline import Pipeline as JPipeline
from repro.pipeline.plan import CompressionPlan as JPlan
from repro.serving import PlanHandle as JHandle
from repro.serving import comp_fingerprint as jfingerprint
from repro.serving import metrics as jmetrics
from repro_torch.configs import get_config as tget
from repro_torch.core import lm_compress as tlc
from repro_torch.core import qat as tqat
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn.layers import QuantConfig as TQ
from repro_torch.nn.spec import params_from_numpy
from repro_torch.pipeline.plan import CompressionPlan as TPlan
from repro_torch.serving import EngineConfig, PlanHandle, ServeRequest
from repro_torch.serving import ServingEngine
from repro_torch.serving import comp_fingerprint as tfingerprint
from repro_torch.serving import metrics as tmetrics

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
SERVE_TOL = 2e-2
STEPS = 10                      # batch-1 decode steps
ROWS, TOTAL, CHUNK = 3, 24, 8
CFG = EngineConfig(max_batch=4, prompt_buckets=(8, 16),
                   new_token_buckets=(8,), max_waves=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work in this file runs on one thread: beside the
    suite's parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def n2t(tree):
    return params_from_numpy(jax.device_get(tree), "cpu")


def t2n(t):
    return t.detach().cpu().numpy()


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_cache_close(t_cache, j_cache, tol=TOL):
    np.testing.assert_array_equal(t2n(t_cache["pos"]),
                                  np.asarray(j_cache["pos"]))
    for key in ("k", "v"):
        assert rel(t2n(t_cache["groups"]["g0"][key]),
                   j_cache["groups"]["g0"][key]) < tol, key


@pytest.fixture(scope="module")
def ref():
    jcfg = jget("olmo-1b").scaled_down(compute_dtype="float32")
    jm = jbuild(jcfg)
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    tm = tbuild(tget("olmo-1b").scaled_down(compute_dtype="float32"))
    jk4 = jlc.restrict_all_codebooks(jm, jlc.init_lm_comp(jm),
                                     jlc.symmetric_codebook_values(4))
    return dict(jm=jm, jp=jp, tm=tm, tp=n2t(jp), vocab=jcfg.vocab, jk4=jk4,
                tk4=n2t(jk4), rng=np.random.default_rng(5))


def forward_kw(ref, plan):
    """(JAX, port) keyword arguments of a forward: uncompressed, or the
    k = 4 fake-quant forward with the JAX package's one activation scale a
    call (the port's default: ``batch_invariant`` off)."""
    if plan == "uncompressed":
        return {}, {}
    return (dict(qcfg=JQ.on(), comp=ref["jk4"]),
            dict(qcfg=TQ.on(), comp=ref["tk4"]))


# ------------------------------------------------ chunks, rows and decode


def _chunk_both(ref, plan, cache, tokens, rows, start, active):
    """One chunk step (gather, ``prefill_chunk``, scatter) in both packages
    from the same numpy group cache; returns the two (logits, cache)."""
    jm, tm = ref["jm"], ref["tm"]
    jkw, tkw = forward_kw(ref, plan)
    j_rows = jm.gather_cache_rows(cache, jnp.asarray(rows))
    j_logits, j_new = jm.prefill_chunk(ref["jp"], j_rows, jnp.asarray(tokens),
                                       start=jnp.asarray(start), **jkw)
    j_cache = jm.scatter_cache_rows(cache, jnp.asarray(rows), j_new,
                                    jnp.asarray(active))
    tc = n2t(cache)
    with torch.no_grad():
        t_rows = tm.gather_cache_rows(tc, torch.from_numpy(rows))
        t_logits, t_new = tm.prefill_chunk(ref["tp"], t_rows,
                                           torch.from_numpy(tokens),
                                           start=torch.from_numpy(start),
                                           **tkw)
        t_cache = tm.scatter_cache_rows(tc, torch.from_numpy(rows), t_new,
                                        torch.from_numpy(active))
    return (t_logits, t_cache), (j_logits, jax.device_get(j_cache))


@pytest.fixture(scope="module", params=["uncompressed", "k4"])
def chunked(ref, request):
    """Three chunk steps into a 3-row group cache, each fed the JAX cache
    of the step before: row 0 alone from 0; rows 0 and 1 at starts 8 and 0
    (one call, two depths); rows 1 and 2, row 2 a padding row. Returns
    (plan, steps, the last cache)."""
    plan, vocab = request.param, ref["vocab"]
    rng = np.random.default_rng(7)
    cache = jax.device_get(ref["jm"].init_cache(ROWS, TOTAL, jnp.float32))
    steps = []
    for rows, start, active in (([0], [0], [True]),
                                ([0, 1], [8, 0], [True, True]),
                                ([1, 2], [8, 0], [True, False])):
        tokens = rng.integers(0, vocab, (len(rows), CHUNK)).astype(np.int32)
        rows, start = np.array(rows, np.int32), np.array(start, np.int32)
        out = _chunk_both(ref, plan, cache, tokens, rows, start,
                          np.array(active))
        steps.append((rows, start, active, cache, out))
        cache = out[1][1]
    return plan, steps, cache


def test_prefill_chunk_on_partly_filled_cache_matches_jax(ref, chunked):
    _, steps, _ = chunked
    vocab = ref["vocab"]
    for i, (rows, start, active, before, (t, j)) in enumerate(steps):
        (t_logits, t_cache), (j_logits, j_cache) = t, j
        assert t_logits.shape == j_logits.shape == (len(rows), CHUNK,
                                                    t_logits.shape[-1])
        assert rel(t2n(t_logits)[..., :vocab],
                   np.asarray(j_logits)[..., :vocab]) < TOL, i
        assert_cache_close(t_cache, j_cache)
        for r in set(range(ROWS)) - {int(x) for x, a in zip(rows, active)
                                     if a}:
            for key in ("k", "v"):      # untouched rows keep their state
                np.testing.assert_array_equal(
                    t2n(t_cache["groups"]["g0"][key][:, r]),
                    before["groups"]["g0"][key][:, r])
    assert steps[-1][4][0][1]["pos"].tolist() == [16, 16, 0]


def test_gather_scatter_rows_match_jax(ref):
    """Row gather and masked scatter move the same data in both packages:
    an inactive row and unlisted rows keep their old state."""
    rng, jm, tm = ref["rng"], ref["jm"], ref["tm"]
    spec = jm.cache_spec(4, TOTAL, jnp.float32)
    cache = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        s.dtype) if s.dtype == np.float32 else rng.integers(
        0, TOTAL, s.shape).astype(s.dtype), spec)
    rows_cache = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype)
        if s.dtype == np.float32 else rng.integers(0, TOTAL, s.shape)
        .astype(s.dtype), jm.cache_spec(3, TOTAL, jnp.float32))
    rows = np.array([2, 0, 3], np.int32)
    active = np.array([True, True, False])
    j_got = jax.device_get(jm.gather_cache_rows(cache, jnp.asarray(rows)))
    t_got = tm.gather_cache_rows(n2t(cache), torch.from_numpy(rows))
    j_put = jax.device_get(jm.scatter_cache_rows(
        cache, jnp.asarray(rows), rows_cache, jnp.asarray(active)))
    t_put = tm.scatter_cache_rows(n2t(cache), torch.from_numpy(rows),
                                  n2t(rows_cache), torch.from_numpy(active))
    for t, j in ((t_got, j_got), (t_put, j_put)):
        np.testing.assert_array_equal(t2n(t["pos"]), j["pos"])
        for key in ("k", "v"):
            np.testing.assert_array_equal(t2n(t["groups"]["g0"][key]),
                                          j["groups"]["g0"][key])
    for key in ("k", "v"):           # rows 1 (unlisted) and 3 (inactive)
        kept = t2n(t_put["groups"]["g0"][key])[:, [1, 3]]
        np.testing.assert_array_equal(kept,
                                      cache["groups"]["g0"][key][:, [1, 3]])


def test_masked_group_decode_matches_jax(ref, chunked):
    """``decode_step(active=...)`` on the partly filled group cache (rows at
    depths 16, 16 and 0), row 1 inactive."""
    plan, _, cache = chunked
    jm, tm, vocab = ref["jm"], ref["tm"], ref["vocab"]
    jkw, tkw = forward_kw(ref, plan)
    tok = np.random.default_rng(8).integers(0, vocab, (ROWS, 1)).astype(
        np.int32)
    active = np.array([True, False, True])
    j_logits, j_cache = jm.decode_step(ref["jp"], cache, jnp.asarray(tok),
                                       active=jnp.asarray(active), **jkw)
    with torch.no_grad():
        t_logits, t_cache = tm.decode_step(ref["tp"], n2t(cache),
                                           torch.from_numpy(tok),
                                           active=torch.from_numpy(active),
                                           **tkw)
    on = active
    assert rel(t2n(t_logits)[on][..., :vocab],
               np.asarray(j_logits)[on][..., :vocab]) < TOL
    assert_cache_close(t_cache, jax.device_get(j_cache))
    assert t2n(t_cache["pos"]).tolist() == [17, 16, 1]
    for key in ("k", "v"):
        np.testing.assert_array_equal(t2n(t_cache["groups"]["g0"][key])[:, 1],
                                      cache["groups"]["g0"][key][:, 1])


def test_batch_invariant_decode_matches_jax_at_batch_one(ref, monkeypatch):
    """The engine's forward (``batch_invariant``: one activation scale a
    token position, float64 sums) on the k = 4 plan against JAX's (one
    scale a call, float32 sums) where the two scales coincide: one row
    decoding one token a call, from an empty cache, each package on its
    own cache. Every activation the port quantizes is
    quantized exactly as JAX's per-call `fake_quant_act` quantizes it, and
    the logits stay within the serve-parity bound."""
    jm, tm, vocab = ref["jm"], ref["tm"], ref["vocab"]
    jkw, _ = forward_kw(ref, "k4")
    tq = TQ(enabled=True, batch_invariant=True)
    seen = []
    real = tqat.fake_quant_act

    def recording(a, cand_dim=None, *, token_dims=0):
        out = real(a, cand_dim, token_dims=token_dims)
        seen.append((t2n(a), t2n(out)))
        return out

    monkeypatch.setattr(tqat, "fake_quant_act", recording)
    rng = np.random.default_rng(9)
    cache = jax.device_get(jm.init_cache(1, TOTAL, jnp.float32))
    j_cache, t_cache = cache, n2t(cache)
    j_decode = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, **jkw))
    errs = []
    for _ in range(STEPS):
        tok = rng.integers(0, vocab, (1, 1)).astype(np.int32)
        j_logits, j_cache = j_decode(ref["jp"], j_cache, jnp.asarray(tok))
        with torch.no_grad():
            t_logits, t_cache = tm.decode_step(
                ref["tp"], t_cache, torch.from_numpy(tok), qcfg=tq,
                comp=ref["tk4"])
        errs.append(rel(t2n(t_logits)[..., :vocab],
                        np.asarray(j_logits)[..., :vocab]))
    # steps x layers x (wq, wk, wv, wo, the FFN's input, w_down's input)
    assert len(seen) == STEPS * 2 * 6
    for a, out in seen:
        np.testing.assert_array_equal(out, np.asarray(jqat.fake_quant_act(
            jnp.asarray(a))))
    assert max(errs) < SERVE_TOL, errs


# -------------------------------------------------------- plan identities


def test_comp_fingerprints_match_jax(ref):
    jm, tm = ref["jm"], ref["tm"]
    ident, jk4 = jlc.init_lm_comp(jm), ref["jk4"]
    tk4 = tlc.restrict_all_codebooks(tm, tlc.init_lm_comp(tm, device="cpu"),
                                     tlc.symmetric_codebook_values(4))
    assert tfingerprint(None) == jfingerprint(None)
    assert tfingerprint(n2t(ident)) == jfingerprint(ident)
    assert tfingerprint(n2t(jk4)) == jfingerprint(jk4) == tfingerprint(tk4)
    assert tfingerprint(tk4, extra="x") == jfingerprint(jk4, extra="x")
    assert tfingerprint(tk4) != tfingerprint(n2t(ident))
    # a handle with MSR truncation: the int msr_bits hash as JAX's do
    assert PlanHandle.from_compress_k(tm, 4, msr_bits=2, device="cpu") \
        .fingerprint == JHandle.from_compress_k(jm, 4, msr_bits=2).fingerprint


def test_plan_fingerprint_matches_jax(ref, tmp_path):
    decisions = [{"layer": "blocks/g0/attn/wq[0]", "share": 0.25,
                  "prune_ratio": None, "k": 4, "accepted": True}]
    for comp, dec in ((jlc.init_lm_comp(ref["jm"]), []),
                      (ref["jk4"], decisions)):
        jplan = JPlan(comp=comp, decisions=dec, completed=("profile",))
        jplan.save(tmp_path / "p")
        tplan = TPlan.load(tmp_path / "p")
        assert tplan.fingerprint() == jplan.fingerprint() \
            == JPlan.load(tmp_path / "p").fingerprint()
        assert PlanHandle.from_compression_plan(tplan).fingerprint \
            == tplan.fingerprint()


def test_per_token_energy_matches_jax(ref, monkeypatch):
    """The k = 4 plan's per-token energy, on the JAX package's uniform-trace
    LUT (the two packages' Monte-Carlo draws differ)."""
    lut = torch.from_numpy(np.array(jelut.uniform_trace_lut()))
    monkeypatch.setattr(tmetrics, "uniform_trace_lut",
                        lambda device="cpu": lut.to(device))
    want = jmetrics.per_token_energy(ref["jm"], ref["jp"], ref["jk4"])
    got = tmetrics.per_token_energy(ref["tm"], ref["tp"], n2t(ref["jk4"]))
    assert got == pytest.approx(want, rel=1e-6)


# ----------------------------------------------------------------- engine


def test_engine_tokens_match_jax_generate(ref):
    """Greedy tokens of exact-fit prompts (8 and 16 tokens, the buckets'
    lengths), uncompressed: the port's engine against JAX's reference
    `generate`, which JAX's own engine reproduces there."""
    rng, vocab = ref["rng"], ref["vocab"]
    prompts = {n: rng.integers(0, vocab, (2, n)).astype(np.int32)
               for n in (8, 16)}
    engine = ServingEngine(ref["tm"], ref["tp"], config=CFG, device="cpu")
    engine.warmup([(8, 8), (16, 8)])
    reqs = [ServeRequest(tokens=p, max_new_tokens=8)
            for n in (8, 16) for p in prompts[n]]
    got = [r.tokens for r in engine.serve(reqs)]
    want = [row.tolist() for n in (8, 16) for row in np.asarray(
        jgenerate(ref["jm"], ref["jp"], jnp.asarray(prompts[n]),
                  new_tokens=8))]
    assert got == want


def test_cli_serves_a_jax_written_k4_plan(tmp_path):
    """``python -m repro_torch serve --plan-in`` on the JAX package's
    reduced olmo-1b plan (k = 4, through schedule): the port exports it and
    serves it on the engine, checked against the oneshot fallback."""
    plan = JPipeline(j_reduced_lm("olmo-1b")).run_until("schedule")
    plan.save(tmp_path / "jax")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "serve", "--plan-in",
         str(tmp_path / "jax"), "--device", "cpu", "--verify-oneshot",
         "--quiet", "--plan-out", str(tmp_path / "served")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout[:proc.stdout.rindex("}") + 1])
    assert summary["completed"][-1] == "serve"
    m = TPlan.load(tmp_path / "served").metrics
    assert m["serve_recompiles_after_warmup"] == 0
    assert m["serve_parity_engine_vs_oneshot"] is True
    assert m["serve_cache_compress_k"] == 4 and m["export_layers"] == 14
