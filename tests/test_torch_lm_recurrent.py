"""Port parity for the recurrent LM families: the Mamba-2 SSD mixer
(`repro_torch.nn.ssm`), the RG-LRU mixer (`repro_torch.nn.rglru`), and the
reduced mamba2-1.3b and recurrentgemma-2b LMs built from them, JAX package
against `repro_torch` on the same numpy arrays.

Sizes: the mixers at d 32-64, chunk 8 (two groups of B/C for the SSD, so
the head-to-group map is exercised); the LMs at `scaled_down()` (d 128,
SSM chunk 32, mamba2 2 layers; recurrentgemma 5 layers, one stacked
(rglru, rglru, local) group and a tail of two rglru blocks, as the full
model's 26 = 8 x 3 + 2), float32 compute.

Tolerances and why:
  * mixers, LM ``forward`` under ``QuantConfig.off()``, ``prefill`` (logits
    and every cache leaf) and ``decode_step``: rel 1e-5. Both run the same
    float32 operations; the products and cumulative sums sum in other
    orders (float32 round-off, ~1e-7 relative).
  * the RG-LRU scan against ``jax.lax.associative_scan``: rel 1e-6, the
    same recursion (one float32 rounding of two at most apart).
  * ``QuantConfig.on()`` logits at k = 4: rel 1e-3 (`ON_TOL`, the dense
    LM's: an activation within ~1e-7 of an int8 rounding boundary can
    quantize one step apart between float32 and correctly rounded sums).
  * prefill followed by decode against the full forward: max abs 1e-3,
    the JAX package's own contract (`tests/test_lm.py`).
  * served (packed artifacts, K2's plain version) against fake-quant: rel
    1e-5 (the served-product rule of the dense LM).
  * the batch-invariant forward (the serving engine's): a batch's rows
    equal to the rows run alone, bit for bit.
  * the bfloat16 forward (the configs' own compute dtype) and a decode
    step: rel 3e-2. Every activation rounds to bfloat16 (~2^-9
    relative) and the two packages' bfloat16 products round apart; the
    dense families land at 0.6-1.1% here, these at 0.9-1.7%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import lm_compress as jlc
from repro.models.lm import build_lm as jbuild
from repro.nn import rglru as jrg
from repro.nn import ssm as jssm
from repro.nn.layers import QuantConfig as JQ
from repro.nn.spec import flatten_with_names as jflat
from repro.nn.spec import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.core import lm_compress as tlc
from repro_torch.core import qat as tqat
from repro_torch.models import config as tmc
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn import rglru as trg
from repro_torch.nn import ssm as tssm
from repro_torch.nn import transformer as tT
from repro_torch.nn.layers import QuantConfig as TQ
from repro_torch.nn.spec import flatten_with_names as tflat
from repro_torch.nn.spec import init_params, params_from_numpy

TOL = 1e-5
ON_TOL = 1e-3
ROUNDTRIP = 1e-3
B, S, MAX_LEN, STEPS = 2, 12, 24, 4
ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")


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


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def reduced(arch, pkg_get):
    extra = {"n_layers": 5} if arch == "recurrentgemma-2b" else {}
    return pkg_get(arch).scaled_down(compute_dtype="float32", **extra)


# ------------------------------------------------------------------ mixers

SSM_DIMS = dict(d_model=32, d_state=16, head_dim=8, n_groups=2, chunk=8)


def ssm_pair(rng):
    jd = jssm.SSMDims(**SSM_DIMS)
    td = tmc.SSMDims(**SSM_DIMS)
    jp = jinit(jax.random.PRNGKey(3), jssm.make_ssm_spec(jd))
    jp = dict(jp, a_log=jnp.asarray(rng.normal(size=jd.n_heads) * 0.5,
                                    jnp.float32),
              conv_b=jnp.asarray(rng.normal(size=jd.conv_dim) * 0.1,
                                 jnp.float32))
    return jd, td, jp, j2t(jp)


def test_ssd_chunked_matches_jax():
    rng = np.random.default_rng(0)
    b, s, h, p, g, n, chunk = 2, 24, 4, 8, 2, 16, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    a = -np.abs(rng.normal(size=(b, s, h)) * 0.3).astype(np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    for init in (None, h0):
        jy, jst = jssm.ssd_chunked(*(jnp.asarray(v) for v in (x, a, bm, cm)),
                                   chunk, None if init is None
                                   else jnp.asarray(init))
        for exact in (False, True):
            ty, tst = tssm.ssd_chunked(
                *(torch.from_numpy(v) for v in (x, a, bm, cm)), chunk,
                None if init is None else torch.from_numpy(init),
                exact=exact)
            assert ty.dtype == tst.dtype == torch.float32
            assert rel(t2n(ty), jy) < TOL and rel(t2n(tst), jst) < TOL
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.ssd_chunked(*(torch.from_numpy(v[:, :20] if v.ndim > 1 else v)
                           for v in (x, a, bm, cm)), chunk)


@pytest.mark.parametrize("seq", [5, 19])
def test_apply_ssm_matches_jax(seq):
    """S not a multiple of the chunk (5 < W - 1 + chunk, 19 across two
    chunks), with ``return_state``: output, final state, conv history."""
    rng = np.random.default_rng(seq)
    jd, td, jp, tp = ssm_pair(rng)
    x = rng.normal(size=(2, seq, jd.d_model)).astype(np.float32)
    jy, jst = jssm.apply_ssm(jp, jnp.asarray(x), jd, return_state=True)
    ty, tst = tssm.apply_ssm(tp, torch.from_numpy(x), td, return_state=True)
    assert rel(t2n(ty), jy) < TOL
    assert list(tst) == list(jst)
    for k in jst:
        assert tst[k].shape == jst[k].shape and tst[k].dtype == torch.float32
        assert rel(t2n(tst[k]), jst[k]) < TOL, k
    assert torch.equal(tssm.apply_ssm(tp, torch.from_numpy(x), td), ty)


def test_apply_ssm_decode_matches_jax():
    rng = np.random.default_rng(7)
    jd, td, jp, tp = ssm_pair(rng)
    x = rng.normal(size=(3, 1, jd.d_model)).astype(np.float32)
    cache = {"state": rng.normal(size=(3, jd.n_heads, jd.head_dim,
                                       jd.d_state)).astype(np.float32),
             "conv": rng.normal(size=(3, jd.conv_width - 1,
                                      jd.conv_dim)).astype(np.float32)}
    jy, jc = jssm.apply_ssm_decode(jp, jnp.asarray(x), jax.tree.map(
        jnp.asarray, cache), jd)
    for exact in (False, True):
        ty, tc = tssm.apply_ssm_decode(
            tp, torch.from_numpy(x), {k: torch.from_numpy(v)
                                      for k, v in cache.items()}, td,
            qcfg=TQ(batch_invariant=exact))
        assert rel(t2n(ty), jy) < TOL
        for k in jc:
            assert tc[k].dtype == torch.float32
            assert rel(t2n(tc[k]), jc[k]) < TOL, k


def test_ssm_spec_and_deterministic_inits_match_jax():
    """Every leaf's shape and axes; ``a_log``, ``dt_bias``, ``d_skip``
    float32 under a bfloat16 parameter dtype, their deterministic inits
    equal to the JAX package's within float32 round-off."""
    jd, td = jssm.SSMDims(**SSM_DIMS), tmc.SSMDims(**SSM_DIMS)
    js = jssm.make_ssm_spec(jd, jnp.bfloat16)
    ts = tssm.make_ssm_spec(td, torch.bfloat16)
    assert list(js) == list(ts)
    for k in js:
        assert tuple(js[k].shape) == ts[k].shape and js[k].axes == ts[k].axes
    for k in ("a_log", "dt_bias", "d_skip"):
        assert ts[k].dtype == torch.float32
    jp = jinit(jax.random.PRNGKey(0), js)
    tp = init_params(0, ts, "cpu")
    for k in ("a_log", "dt_bias", "d_skip", "norm_scale", "conv_b"):
        np.testing.assert_allclose(t2n(tp[k].float()),
                                   np.asarray(jp[k], np.float32),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("seq", [1, 2, 7, 16, 33])
def test_linear_scan_matches_associative_scan(seq):
    rng = np.random.default_rng(seq)
    a = rng.uniform(0.5, 1.0, (2, seq, 6)).astype(np.float32)
    bx = rng.normal(size=(2, seq, 6)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(bx)), axis=1)
    got = trg.linear_scan(torch.from_numpy(a), torch.from_numpy(bx))
    assert rel(t2n(got), want) < 1e-6
    h, loop = np.zeros((2, 6), np.float64), []
    for t in range(seq):
        h = a[:, t] * h + bx[:, t]
        loop.append(h)
    assert rel(t2n(got), np.stack(loop, 1)) < TOL


RG_DIMS = dict(d_model=32, d_rnn=48)


def rglru_pair():
    jd, td = jrg.RGLRUDims(**RG_DIMS), tmc.RGLRUDims(**RG_DIMS)
    jp = jinit(jax.random.PRNGKey(4), jrg.make_rglru_spec(jd))
    return jd, td, jp, j2t(jp)


@pytest.mark.parametrize("seq", [2, 13])
def test_apply_rglru_matches_jax(seq):
    rng = np.random.default_rng(seq)
    jd, td, jp, tp = rglru_pair()
    x = rng.normal(size=(2, seq, jd.d_model)).astype(np.float32)
    jy, jst = jrg.apply_rglru(jp, jnp.asarray(x), jd, return_state=True)
    ty, tst = trg.apply_rglru(tp, torch.from_numpy(x), td, return_state=True)
    assert rel(t2n(ty), jy) < TOL
    assert list(tst) == list(jst)
    for k in jst:
        assert tst[k].shape == jst[k].shape
        assert rel(t2n(tst[k]), jst[k]) < TOL, k


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_apply_rglru_decode_matches_jax(cache_dtype):
    """The conv history promotes as ``jnp.concatenate`` does: a float32
    cache makes the step's conv output and gate products float32 on a
    bfloat16 stream, so the new state holds to rel 1e-5; a bfloat16 cache
    keeps them bfloat16, where the two packages' bfloat16 products round
    apart (rel 1e-2, two bfloat16 ulps)."""
    rng = np.random.default_rng(11)
    jd, td, jp, tp = rglru_pair()
    x = rng.normal(size=(3, 1, jd.d_model)).astype(np.float32)
    cache = {"h": rng.normal(size=(3, jd.d_rnn)).astype(np.float32),
             "conv": rng.normal(size=(3, jd.conv_width - 1,
                                      jd.d_rnn)).astype(np.float32)}
    jcache = {"h": jnp.asarray(cache["h"]),
              "conv": jnp.asarray(cache["conv"], cache_dtype)}
    tcache = {"h": torch.from_numpy(cache["h"]),
              "conv": torch.from_numpy(cache["conv"]).to(
                  getattr(torch, cache_dtype))}
    jy, jc = jrg.apply_rglru_decode(jp, jnp.asarray(x, jnp.bfloat16),
                                    jcache, jd)
    ty, tc = trg.apply_rglru_decode(tp, torch.from_numpy(x).bfloat16(),
                                    tcache, td)
    assert str(ty.dtype).split(".")[1] == str(jy.dtype)
    assert rel(t2n(ty.float()), np.asarray(jy, np.float32)) < 1e-2
    for k in jc:
        assert str(tc[k].dtype).split(".")[1] == str(jc[k].dtype), k
    assert rel(t2n(tc["h"]), jc["h"]) < (TOL if cache_dtype == "float32"
                                         else 1e-2)
    np.testing.assert_array_equal(t2n(tc["conv"].float())[:, :-1],
                                  np.asarray(jc["conv"], np.float32)[:, :-1])


def test_lambda_init_is_seeded_and_in_range():
    spec = trg.make_rglru_spec(tmc.RGLRUDims(**RG_DIMS), torch.bfloat16)
    assert spec["lam"].dtype == torch.float32
    a, b = init_params(5, spec, "cpu"), init_params(5, spec, "cpu")
    assert torch.equal(a["lam"], b["lam"])
    u = torch.exp(-tssm.softplus(a["lam"]))
    assert bool(((u > 0.9 - 1e-6) & (u < 0.999 + 1e-6)).all())


# ------------------------------------------------------------------ LMs


def restricted(jm):
    """k = 4 on every unit."""
    return jlc.restrict_all_codebooks(jm, jlc.init_lm_comp(jm),
                                      jlc.symmetric_codebook_values(4))


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """A reduced recurrent LM in both packages, its JAX parameters carried
    across, and the JAX reference outputs, computed once."""
    arch = request.param
    jcfg, tcfg = reduced(arch, jget), reduced(arch, tget)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    jcomp = restricted(jm)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab, (STEPS, B, 1)).astype(np.int32)
    out = dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm, jp=jp,
               tp=j2t(jp), jcomp=jcomp, tcomp=j2t(jcomp), tokens=tokens,
               nxt=nxt)
    tok = jnp.asarray(tokens)
    out["off"] = jm.forward(jp, tok)[0]
    out["on"] = jm.forward(jp, tok, qcfg=JQ.on(), comp=jcomp)[0]
    logits, cache = jm.prefill(jp, tok, MAX_LEN, cache_dtype=jnp.float32)
    out["prefill"], out["prefill_cache"] = logits, cache
    steps = []
    for i in range(STEPS):
        logits, cache = jm.decode_step(jp, cache, jnp.asarray(nxt[i]))
        steps.append(logits)
    out["decode"] = steps
    return out


def logit_rel(t_logits, j_logits, vocab):
    t, j = t2n(t_logits), np.asarray(j_logits)
    assert (t[..., vocab:] == -1e30).all() and (j[..., vocab:] == -1e30).all()
    return rel(t[..., :vocab], j[..., :vocab])


def test_spec_and_params_carry_across(ref):
    jf, tf = jflat(ref["jm"].spec), tflat(ref["tm"].spec)
    assert list(jf) == list(tf)
    for name in jf:
        assert tuple(jf[name].shape) == tuple(tf[name].shape), name
        assert tuple(jf[name].axes) == tuple(tf[name].axes), name
    jp, tp = tflat(jax.device_get(ref["jp"])), tflat(ref["tp"])
    for name, v in jp.items():
        np.testing.assert_array_equal(t2n(tp[name]), v)
        assert str(tp[name].dtype).split(".")[1] == str(v.dtype), name


def test_forward_matches_jax(ref):
    with torch.no_grad():
        got = ref["tm"].forward(ref["tp"], torch.from_numpy(ref["tokens"]))[0]
    assert logit_rel(got, ref["off"], ref["jcfg"].vocab) < TOL


def test_prefill_and_decode_match_jax(ref):
    tm, vocab = ref["tm"], ref["jcfg"].vocab
    with torch.no_grad():
        logits, cache = tm.prefill(ref["tp"], torch.from_numpy(ref["tokens"]),
                                   MAX_LEN, cache_dtype=torch.float32)
        assert logit_rel(logits, ref["prefill"], vocab) < TOL
        jc, tc = tflat(jax.device_get(ref["prefill_cache"])), tflat(cache)
        assert list(jc) == list(tc)
        spec = tflat(tm.cache_spec(B, MAX_LEN, torch.bfloat16))
        for name, v in jc.items():
            assert tuple(tc[name].shape) == v.shape, name
            assert str(tc[name].dtype).split(".")[1] == str(v.dtype), name
            if name.endswith(("state", "/h", "conv")):
                assert spec[name].dtype == torch.float32, name
            assert rel(t2n(tc[name]), v) < TOL, name
        for i in range(STEPS):
            logits, cache = tm.decode_step(ref["tp"], cache,
                                           torch.from_numpy(ref["nxt"][i]))
            assert logit_rel(logits, ref["decode"][i], vocab) < TOL, i


def test_fake_quant_forward_matches_jax(ref):
    with torch.no_grad():
        got = ref["tm"].forward(ref["tp"], torch.from_numpy(ref["tokens"]),
                                qcfg=TQ.on(), comp=ref["tcomp"])[0]
    assert logit_rel(got, ref["on"], ref["jcfg"].vocab) < ON_TOL


def test_prefill_then_decode_equals_forward(ref):
    """JAX's roundtrip contract (`tests/test_lm.py`): a prefill of 16
    tokens then 6 decode steps reproduce the full forward's logits, the
    recurrent states carried in float32."""
    tm, vocab = ref["tm"], ref["jcfg"].vocab
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, vocab, (B, 22)).astype(np.int32))
    with torch.no_grad():
        full = tm.forward(ref["tp"], toks, q_block=8, kv_block=8)[0]
        lg, cache = tm.prefill(ref["tp"], toks[:, :16], 30,
                               cache_dtype=torch.float32, q_block=8,
                               kv_block=8)
        errs = [float((lg - full[:, :16])[..., :vocab].abs().max())]
        for t in range(16, 22):
            lg, cache = tm.decode_step(ref["tp"], cache, toks[:, t:t + 1])
            errs.append(float((lg[:, 0] - full[:, t])[..., :vocab].abs()
                              .max()))
    assert max(errs) < ROUNDTRIP, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_forward_and_decode_match_jax(arch):
    """At the configs' bfloat16 compute dtype (the casts of the mixers:
    bfloat16 streams, float32 recurrent states and decay terms, a bfloat16
    conv history after prefill): forward, then one decode step from a
    prefill's cache, whose leaves keep JAX's dtypes."""
    jcfg = jget(arch).scaled_down(compute_dtype="bfloat16")
    tcfg = tget(arch).scaled_down(compute_dtype="bfloat16")
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    tp = j2t(jp)
    rng = np.random.default_rng(6)
    tok = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
    jl = jm.forward(jp, jnp.asarray(tok))[0]
    _, jcache = jm.prefill(jp, jnp.asarray(tok), MAX_LEN)
    jd, _ = jm.decode_step(jp, jcache, jnp.asarray(nxt))
    with torch.no_grad():
        tl = tm.forward(tp, torch.from_numpy(tok))[0]
        _, tcache = tm.prefill(tp, torch.from_numpy(tok), MAX_LEN)
        td, _ = tm.decode_step(tp, tcache, torch.from_numpy(nxt))
    vocab = jcfg.vocab
    assert logit_rel(tl, np.asarray(jl, np.float32), vocab) < 3e-2
    assert logit_rel(td, np.asarray(jd, np.float32), vocab) < 3e-2
    jc, tc = tflat(jax.device_get(jcache)), tflat(tcache)
    assert {k: str(v.dtype) for k, v in jc.items()} == \
        {k: str(v.dtype).split(".")[1] for k, v in tc.items()}


def test_one_grouped_k3_call_covers_every_unit(ref, monkeypatch):
    """A fake-quant forward fake-quantizes every compressible unit
    (`lm_compress.ELIGIBLE`'s) in the grouped calls of
    `LMModel._fake_quant_units`: one for the stacked groups (the layer axis
    as K3's candidate axis), one more for a tail; no unit falls to a call
    of its own."""
    tm = ref["tm"]
    calls = []
    real = tqat.fake_quant_weights

    def counted(ws, comps, cands=None):
        calls.append((len(ws), cands))
        return real(ws, comps, cands)

    monkeypatch.setattr(tqat, "fake_quant_weights", counted)
    with torch.no_grad():
        tm.forward(ref["tp"], torch.from_numpy(ref["tokens"]), qcfg=TQ.on(),
                   comp=ref["tcomp"])
    units = tlc.lm_comp_layers(tm)
    stacked = [u for u in units if u.startswith("blocks/")]
    tail = [u for u in units if u.startswith("tail/")]
    want = [(len(stacked), tm.n_rep)] + ([(len(tail), None)] if tail else [])
    assert calls == want
    assert len(units) == len(jlc.lm_comp_layers(ref["jm"]))
    covered = [f"{top}/{g}/{u}" for top in ("blocks", "tail")
               for g, block in ref["tp"].get(top, {}).items()
               for u in tT.block_matmuls(block)]
    assert covered == units == jlc.lm_comp_layers(ref["jm"])


def test_served_forward_matches_fake_quant(ref):
    """Every unit served from its packed artifact (K2's plain version on the
    CPU): prefill and a decode step against the fake-quant forward."""
    tm = ref["tm"]
    comp_serve, n = tlc.attach_serve_artifacts(tm, ref["tp"], ref["tcomp"])
    assert n == len(tlc.lm_comp_layers(tm))
    toks = torch.from_numpy(ref["tokens"])
    with torch.no_grad():
        out = {}
        for label, qcfg, comp in (("served", TQ.serve(), comp_serve),
                                  ("fake_quant", TQ.on(), ref["tcomp"])):
            lg, cache = tm.prefill(ref["tp"], toks, MAX_LEN, qcfg=qcfg,
                                   comp=comp, cache_dtype=torch.float32)
            step, _ = tm.decode_step(ref["tp"], cache, toks[:, -1:],
                                     qcfg=qcfg, comp=comp)
            out[label] = (lg, step)
    vocab = ref["jcfg"].vocab
    for i in range(2):
        assert logit_rel(out["served"][i], t2n(out["fake_quant"][i]),
                         vocab) < TOL


def test_batch_invariant_rows_equal_rows_alone(ref):
    """The serving engine's forward (``batch_invariant``, k = 4
    fake-quant): a batch's prefill and decode rows equal, bit for bit, the
    same rows run alone."""
    tm = ref["tm"]
    qcfg = TQ(enabled=True, batch_invariant=True)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, ref["jcfg"].vocab, (3, S)).astype(np.int32))
    with torch.no_grad():
        both, cache = tm.prefill(ref["tp"], toks, MAX_LEN, qcfg=qcfg,
                                 comp=ref["tcomp"],
                                 cache_dtype=torch.float32)
        step, _ = tm.decode_step(ref["tp"], cache, toks[:, :1], qcfg=qcfg,
                                 comp=ref["tcomp"])
        for r in range(3):
            alone, c1 = tm.prefill(ref["tp"], toks[r:r + 1], MAX_LEN,
                                   qcfg=qcfg, comp=ref["tcomp"],
                                   cache_dtype=torch.float32)
            assert torch.equal(alone, both[r:r + 1])
            one, _ = tm.decode_step(ref["tp"], c1, toks[r:r + 1, :1],
                                    qcfg=qcfg, comp=ref["tcomp"])
            assert torch.equal(one, step[r:r + 1])


def test_cache_rows_gather_scatter_and_active(ref):
    """Recurrent leaves (no sequence axis) through the engine's row
    shuffles and the active mask: gathered rows are the rows, scattered
    rows land at their slots (in the group cache's float32), an inactive
    row keeps its state."""
    tm = ref["tm"]
    toks = torch.from_numpy(ref["tokens"])
    with torch.no_grad():
        _, cache = tm.prefill(ref["tp"], toks, MAX_LEN,
                              cache_dtype=torch.float32)
        rows = torch.tensor([1, 0], dtype=torch.int32)
        got = tm.gather_cache_rows(cache, rows)
        for name, v in tflat(got).items():
            full = tflat(cache)[name]
            axis = 1 if name.startswith("groups") else 0
            assert torch.equal(v, full.index_select(axis, rows.long()))
        group = tm.init_cache(3, MAX_LEN, torch.bfloat16, device="cpu")
        back = tm.scatter_cache_rows(group, torch.tensor([2, 0]),
                                     cache, torch.tensor([True, False]))
        for name, v in tflat(back).items():
            assert v.dtype == tflat(group)[name].dtype, name
            axis = 1 if name.startswith("groups") else 0
            src = tflat(cache)[name].index_select(axis, torch.tensor([0]))
            assert torch.equal(v.index_select(axis, torch.tensor([2])),
                               src.to(v.dtype)), name
            assert torch.equal(v.index_select(axis, torch.tensor([0, 1])),
                               tflat(group)[name].index_select(
                                   axis, torch.tensor([0, 1]))), name
        _, new = tm.decode_step(ref["tp"], cache, toks[:, :1],
                                active=torch.tensor([True, False]))
        for name, v in tflat(new).items():
            if name == "pos":
                continue
            axis = 1 if name.startswith("groups") else 0
            keep = tflat(cache)[name].index_select(axis, torch.tensor([1]))
            assert torch.equal(v.index_select(axis, torch.tensor([1])),
                               keep), name
