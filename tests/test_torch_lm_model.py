"""Port parity for the LM stack: configs, specs, layers, attention, FFN and
the dense LM's forward / prefill / decode, JAX package against
`repro_torch` on the same numpy arrays (reduced olmo-1b: 2 layers, d 128,
4 query heads over 2 KV heads, so GQA; float32 compute).

Tolerances and why:
  * RoPE, attention, FFN, norms, ``forward`` under ``QuantConfig.off()``,
    ``prefill`` and ``decode_step`` (float32 cache): rel 1e-5. Both run the
    same float32 operations; only summation orders differ (float32
    round-off, ~1e-7 relative).
  * ``QuantConfig.on()`` logits: rel < 1e-3. The port's fake-quant
    products are correctly rounded (float64 sums, `exact_matmul`) and
    JAX's are float32 sums, so an activation within ~1e-7 of an int8
    rounding boundary can quantize one step apart (a 1/127 change of one
    element), which later layers carry to the logits; with none it is
    ~1e-7. The bound leaves a few such flips room and is far below the
    served-vs-fake-quant gate of 2e-2.
  * served products: bit for bit `exact_matmul` of the artifact's
    dequantized weight (the served-product rule); served vs fake-quant
    logits in the port: rel 1e-5 (the straight-through weight is the
    artifact's up to the rounding of ``wm + (wq - wm)``, a few float32 ulps
    at most; at this size no activation rounding flips).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jget
from repro.core import lm_compress as jlc
from repro.core import qat as jqat
from repro.models import config as jmc
from repro.models.lm import build_lm as jbuild
from repro.nn import attention as jA
from repro.nn import layers as jL
from repro.nn import transformer as jT
from repro.nn.layers import QuantConfig as JQ
from repro.nn.spec import flatten_with_names as jflat
from repro.nn.spec import init_params as jinit
from repro.nn.spec import spec_count as jcount
from repro_torch.configs import get_config as tget
from repro_torch.core import lm_compress as tlc
from repro_torch.core import qat as tqat
from repro_torch.core import export as texport
from repro_torch.kernels.fake_quant import ops as fq_ops
from repro_torch.kernels.lut_matmul import ref as k2ref
from repro_torch.models import config as tmc
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn import attention as tA
from repro_torch.nn import layers as tL
from repro_torch.nn import moe as tmoe
from repro_torch.nn import transformer as tT
from repro_torch.nn.layers import QuantConfig as TQ
from repro_torch.nn.spec import flatten_with_names as tflat
from repro_torch.nn.spec import params_from_numpy
from repro_torch.nn.spec import spec_count as tcount

TOL = 1e-5
ON_TOL = 1e-3
B, S, MAX_LEN, DECODE_STEPS = 2, 12, 16, 4
DENSE = ("olmo-1b", "phi3-mini-3.8b", "qwen2.5-14b", "gemma3-4b")
# the families beyond the dense one: recurrent, MoE, the encoder-decoder,
# the VLM backbone
OTHER_FAMILIES = ("internvl2-26b", "mamba2-1.3b", "moonshot-v1-16b-a3b",
                  "phi3.5-moe-42b-a6.6b", "recurrentgemma-2b",
                  "whisper-large-v3")
MOE = ("phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b")


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


def logit_rel(t_logits, j_logits, vocab):
    """rel err over the real vocab; the padding must be -1e30 in both."""
    t, j = t2n(t_logits), np.asarray(j_logits)
    assert (t[..., vocab:] == -1e30).all() and (j[..., vocab:] == -1e30).all()
    return rel(t[..., :vocab], j[..., :vocab])


def restricted(jm):
    """k = 16 on every unit, k = 4 on layer 1's w_down."""
    comp = jlc.restrict_all_codebooks(jm, jlc.init_lm_comp(jm),
                                      jlc.symmetric_codebook_values(16))
    return jlc.set_codebook(comp, "blocks/g0/mlp/w_down",
                            jlc.symmetric_codebook_values(4), layer=1)


@pytest.fixture(scope="module")
def ref():
    """The reduced olmo-1b in both packages, its JAX parameters carried
    across, and the JAX reference outputs, computed once."""
    jcfg = jget("olmo-1b").scaled_down(compute_dtype="float32")
    tcfg = tget("olmo-1b").scaled_down(compute_dtype="float32")
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    jcomp = restricted(jm)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    out = dict(jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm, jp=jp, tp=j2t(jp),
               jcomp=jcomp, tcomp=j2t(jcomp), tokens=tokens)
    tok = jnp.asarray(tokens)
    out["off"] = jax.jit(lambda p, t: jm.forward(p, t)[0])(jp, tok)
    out["on"] = jax.jit(lambda p, t, c: jm.forward(
        p, t, qcfg=JQ.on(), comp=c)[0])(jp, tok, jcomp)
    jserve, _ = jlc.attach_serve_artifacts(jm, jp, jcomp)
    out["serve"] = jm.forward(jp, tok, qcfg=JQ.serve(use_ref_kernel=True),
                              comp=jserve)[0]
    logits, cache = jm.prefill(jp, tok, MAX_LEN, cache_dtype=jnp.float32)
    out["prefill"], out["prefill_cache"] = logits, cache
    steps = []
    nxt = rng.integers(0, jcfg.vocab, (DECODE_STEPS, B, 1)).astype(np.int32)
    for i in range(DECODE_STEPS):
        logits, cache = jm.decode_step(jp, cache, jnp.asarray(nxt[i]))
        steps.append(logits)
    out["decode_tokens"], out["decode"], out["decode_cache"] = nxt, steps, \
        cache
    active = np.array([True, False])
    out["active_logits"], out["active_cache"] = jm.decode_step(
        jp, out["prefill_cache"], jnp.asarray(nxt[0]),
        active=jnp.asarray(active))
    out["active"] = active
    return out


# ------------------------------------------------------------ configs, specs


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_match_jax(arch):
    j, t = jget(arch), tget(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for cfg_j, cfg_t in ((j, t), (j.scaled_down(), t.scaled_down())):
        assert tmc.model_param_count(cfg_t) == jmc.model_param_count(cfg_j)
        assert cfg_t.padded_vocab == cfg_j.padded_vocab
        assert cfg_t.layer_types() == cfg_j.layer_types()
        assert dataclasses.asdict(cfg_t.attn_dims(True)) == \
            dataclasses.asdict(cfg_j.attn_dims(True))
        assert str(cfg_t.cdtype).replace("torch.", "") == \
            str(jnp.dtype(cfg_j.cdtype))


def test_olmo_1b_full_width_spec_matches_jax():
    """1.177e9 parameters at the published width; every key path, shape
    and logical axis of the spec tree equal to the JAX package's."""
    jm, tm = jbuild(jget("olmo-1b")), tbuild(tget("olmo-1b"))
    assert tcount(tm.spec) == jcount(jm.spec)
    assert round(tcount(tm.spec) / 1e9, 3) == 1.177
    jf, tf = jflat(jm.spec), tflat(tm.spec)
    assert list(jf) == list(tf)
    for name in jf:
        assert tuple(jf[name].shape) == tuple(tf[name].shape), name
        assert tuple(jf[name].axes) == tuple(tf[name].axes), name


@pytest.mark.parametrize("arch", DENSE[1:])
def test_other_dense_families_build(arch):
    jm = jbuild(jget(arch).scaled_down())
    tm = tbuild(tget(arch).scaled_down())
    assert tcount(tm.spec) == jcount(jm.spec)
    assert list(jflat(jm.spec)) == list(tflat(tm.spec))


@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_other_families_build_as_jax_and_take_its_params(arch):
    """The recurrent families (mamba2, recurrentgemma), the MoE family
    (phi3.5-moe, moonshot: its forward, prefill and decode are held to
    JAX's in `test_moe_family_forward_prefill_decode_match_jax`), the
    encoder-decoder (whisper) and the VLM (internvl2: its prefix is held
    to JAX's in `tests/test_torch_lm_vlm.py`) build, spec for spec the JAX
    package's, and JAX's parameters carry across."""
    jm, tm = jbuild(jget(arch).scaled_down()), tbuild(tget(arch).scaled_down())
    assert tcount(tm.spec) == jcount(jm.spec)
    jp = jflat(jax.device_get(jinit(jax.random.PRNGKey(0), jm.spec)))
    tp = tflat(params_from_numpy(jp, "cpu"))
    assert list(jp) == list(tp) == list(tflat(tm.spec))
    for name, v in jp.items():
        assert tuple(tp[name].shape) == tuple(tflat(tm.spec)[name].shape)
        np.testing.assert_array_equal(t2n(tp[name]), v)


def test_params_carry_across_stacked(ref):
    jf, tf = jflat(jax.device_get(ref["jp"])), tflat(ref["tp"])
    assert list(jf) == list(tf)
    for name, a in jf.items():
        assert tuple(tf[name].shape) == a.shape
        np.testing.assert_array_equal(t2n(tf[name]), a)
    assert tf["blocks/g0/attn/wq"].shape[0] == ref["tcfg"].n_layers


def test_init_is_seeded_and_per_layer():
    """Stacked leaves draw each layer at its own fan-in: layer slices of
    wq have the (d, H, hd) fan-in's scale, not the layer count's."""
    from repro_torch.nn.spec import init_params

    tm = tbuild(tget("olmo-1b").scaled_down())
    a = init_params(3, tm.spec, "cpu")
    b = init_params(3, tm.spec, "cpu")
    wq = a["blocks"]["g0"]["attn"]["wq"]
    assert torch.equal(wq, b["blocks"]["g0"]["attn"]["wq"])
    assert not torch.equal(wq[0], wq[1])
    assert abs(float(wq.std()) - 128 ** -0.5) < 0.01


# ------------------------------------------------------------------ layers


def test_norms_gelu_embed_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    xt = torch.from_numpy(x)
    assert rel(t2n(tL.apply_rmsnorm({"scale": torch.from_numpy(scale)}, xt)),
               jL.apply_rmsnorm({"scale": scale}, x)) < TOL
    p = {"scale": scale, "bias": bias}
    assert rel(t2n(tL.apply_layernorm(j2t(p), xt)),
               jL.apply_layernorm(p, x)) < TOL
    assert rel(t2n(tL.apply_layernorm({}, xt)),
               jL.apply_layernorm({}, x)) < TOL
    assert rel(t2n(tL.gelu(xt)), jL.gelu(x)) < TOL
    table = rng.normal(size=(32, 64)).astype(np.float32)
    ids = rng.integers(0, 32, (3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        t2n(tL.apply_embed({"table": torch.from_numpy(table)},
                           torch.from_numpy(ids))),
        np.asarray(jL.apply_embed({"table": table}, ids)))
    assert rel(t2n(tL.apply_unembed({"table": torch.from_numpy(table)}, xt)),
               jL.apply_unembed({"table": table}, x)) < TOL


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 9)).astype(np.int32)
    got = tA.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    assert rel(t2n(got), jA.apply_rope(x, pos, 1e4)) < TOL


def _layer0(tree, sub):
    return {k: v[0] for k, v in tree["blocks"]["g0"][sub].items()}


@pytest.mark.parametrize("blocks", [(512, 512), (8, 8)])
def test_apply_attention_gqa_causal_matches_jax(ref, blocks):
    """GQA (4 query heads over 2 KV heads), causal, with the returned K/V;
    (8, 8) blocks pad S = 12 and walk two key blocks with the online
    softmax."""
    jp, tp = _layer0(ref["jp"], "attn"), _layer0(ref["tp"], "attn")
    dims = ref["jcfg"].attn_dims(False)
    assert dims.n_heads != dims.n_kv_heads
    x = np.random.default_rng(3).normal(size=(B, S, 128)).astype(np.float32)
    qb, kb = blocks
    jy, (jk, jv) = jA.apply_attention(jp, x, dims, q_block=qb, kv_block=kb,
                                      return_kv=True)
    ty, (tk, tv) = tA.apply_attention(tp, torch.from_numpy(x),
                                      ref["tcfg"].attn_dims(False),
                                      q_block=qb, kv_block=kb,
                                      return_kv=True)
    assert rel(t2n(ty), jy) < TOL
    assert rel(t2n(tk), jk) < TOL and rel(t2n(tv), jv) < TOL


def test_apply_ffn_matches_jax(ref):
    jp, tp = _layer0(ref["jp"], "mlp"), _layer0(ref["tp"], "mlp")
    x = np.random.default_rng(4).normal(size=(B, S, 128)).astype(np.float32)
    got = tT.apply_ffn(tp, torch.from_numpy(x), ref["tcfg"])
    assert rel(t2n(got), jT.apply_ffn(jp, x, ref["jcfg"])) < TOL


# ------------------------------------------------------------------ model


def test_forward_off_matches_jax(ref):
    logits, aux = ref["tm"].forward(ref["tp"], torch.from_numpy(ref["tokens"]))
    assert logits.dtype == torch.float32
    assert logit_rel(logits, ref["off"], ref["jcfg"].vocab) < TOL
    assert float(aux["lb_loss"]) == 0.0


def test_prefill_and_decode_match_jax(ref):
    tm, tp, vocab = ref["tm"], ref["tp"], ref["jcfg"].vocab
    logits, cache = tm.prefill(tp, torch.from_numpy(ref["tokens"]), MAX_LEN,
                               cache_dtype=torch.float32)
    assert logit_rel(logits, ref["prefill"], vocab) < TOL
    spec = tm.cache_spec(B, MAX_LEN, torch.float32)
    for key in ("k", "v"):
        assert tuple(spec["groups"]["g0"][key].shape) == tuple(
            cache["groups"]["g0"][key].shape) == \
            ref["prefill_cache"]["groups"]["g0"][key].shape
        assert rel(t2n(cache["groups"]["g0"][key]),
                   ref["prefill_cache"]["groups"]["g0"][key]) < TOL
    np.testing.assert_array_equal(t2n(cache["pos"]),
                                  ref["prefill_cache"]["pos"])
    for i in range(DECODE_STEPS):
        logits, cache = tm.decode_step(
            tp, cache, torch.from_numpy(ref["decode_tokens"][i]))
        assert logit_rel(logits, ref["decode"][i], vocab) < TOL, i
    for key in ("k", "v"):
        assert rel(t2n(cache["groups"]["g0"][key]),
                   ref["decode_cache"]["groups"]["g0"][key]) < TOL
    np.testing.assert_array_equal(t2n(cache["pos"]),
                                  ref["decode_cache"]["pos"])


def test_decode_inactive_rows_keep_their_cache(ref):
    tm, tp = ref["tm"], ref["tp"]
    _, cache = tm.prefill(tp, torch.from_numpy(ref["tokens"]), MAX_LEN,
                          cache_dtype=torch.float32)
    logits, new = tm.decode_step(
        tp, cache, torch.from_numpy(ref["decode_tokens"][0]),
        active=torch.from_numpy(ref["active"]))
    assert logit_rel(logits[:1], ref["active_logits"][:1],
                     ref["jcfg"].vocab) < TOL
    np.testing.assert_array_equal(t2n(new["pos"]), ref["active_cache"]["pos"])
    for key in ("k", "v"):
        assert torch.equal(new["groups"]["g0"][key][:, 1],
                           cache["groups"]["g0"][key][:, 1])
        assert rel(t2n(new["groups"]["g0"][key]),
                   ref["active_cache"]["groups"]["g0"][key]) < TOL


def test_forward_on_within_stated_bound(ref):
    logits, _ = ref["tm"].forward(ref["tp"], torch.from_numpy(ref["tokens"]),
                                  qcfg=TQ.on(), comp=ref["tcomp"])
    assert logit_rel(logits, ref["on"], ref["jcfg"].vocab) < ON_TOL


# the other dense families: qkv_bias (qwen2.5), rope_theta_local,
# embed_scale and a layer tail (gemma3 at 10 layers: one 6-layer repeat of
# its 5:1 local:global pattern, then a 4-layer tail)
OTHER_DENSE = {"phi3-mini-3.8b": {}, "qwen2.5-14b": {},
               "gemma3-4b": {"n_layers": 10}}


@pytest.fixture(scope="module", params=sorted(OTHER_DENSE))
def dense_ref(request):
    """A reduced dense family in both packages, JAX's parameters and its
    k = 4 comp carried across, and the JAX reference outputs."""
    arch = request.param
    kw = dict(compute_dtype="float32", **OTHER_DENSE[arch])
    jcfg, tcfg = jget(arch).scaled_down(**kw), tget(arch).scaled_down(**kw)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    jcomp = jlc.restrict_all_codebooks(jm, jlc.init_lm_comp(jm),
                                       jlc.symmetric_codebook_values(4))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab, (DECODE_STEPS, B, 1)).astype(np.int32)
    tok = jnp.asarray(tokens)
    out = dict(jcfg=jcfg, tm=tm, tp=j2t(jp), tcomp=j2t(jcomp),
               tokens=tokens, decode_tokens=nxt)
    out["off"] = jax.jit(lambda p, t: jm.forward(p, t)[0])(jp, tok)
    out["on"] = jax.jit(lambda p, t, c: jm.forward(
        p, t, qcfg=JQ.on(), comp=c)[0])(jp, tok, jcomp)
    logits, cache = jax.jit(lambda p, t: jm.prefill(
        p, t, MAX_LEN, cache_dtype=jnp.float32))(jp, tok)
    out["prefill"], out["decode"] = logits, []
    decode = jax.jit(jm.decode_step)
    for i in range(DECODE_STEPS):
        logits, cache = decode(jp, cache, jnp.asarray(nxt[i]))
        out["decode"].append(logits)
    return out


def test_other_dense_family_forward_prefill_decode_match_jax(dense_ref):
    """The olmo-1b parity tests' forward, prefill and decode, at TOL, for
    phi3-mini, qwen2.5 (qkv_bias) and gemma3 (local/global RoPE thetas,
    embed_scale, a 4-layer tail)."""
    r = dense_ref
    tm, tp, vocab = r["tm"], r["tp"], r["jcfg"].vocab
    tok = torch.from_numpy(r["tokens"])
    assert logit_rel(tm.forward(tp, tok)[0], r["off"], vocab) < TOL
    logits, cache = tm.prefill(tp, tok, MAX_LEN, cache_dtype=torch.float32)
    assert logit_rel(logits, r["prefill"], vocab) < TOL
    for i in range(DECODE_STEPS):
        logits, cache = tm.decode_step(
            tp, cache, torch.from_numpy(r["decode_tokens"][i]))
        assert logit_rel(logits, r["decode"][i], vocab) < TOL, i


def test_other_dense_family_fake_quant_forward_within_stated_bound(
        dense_ref):
    r = dense_ref
    logits, _ = r["tm"].forward(r["tp"], torch.from_numpy(r["tokens"]),
                                qcfg=TQ.on(), comp=r["tcomp"])
    assert logit_rel(logits, r["on"], r["jcfg"].vocab) < ON_TOL


@pytest.fixture(scope="module", params=MOE)
def moe_ref(request):
    """A reduced MoE family (2 layers, 4 experts, top-2; moonshot with a
    shared expert) in both packages, and the JAX outputs: the forward off
    and at k = 4, prefill and decode, with each prefill layer's top-k
    choices recorded in both packages (JAX's prefill runs eagerly)."""
    arch = request.param
    jcfg = jget(arch).scaled_down(compute_dtype="float32")
    tcfg = tget(arch).scaled_down(compute_dtype="float32")
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    jcomp = jlc.restrict_all_codebooks(jm, jlc.init_lm_comp(jm),
                                       jlc.symmetric_codebook_values(4))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab, (DECODE_STEPS, B, 1)).astype(np.int32)
    tok = jnp.asarray(tokens)
    out = dict(jcfg=jcfg, tm=tm, tp=j2t(jp), tcomp=j2t(jcomp),
               tokens=tokens, decode_tokens=nxt)
    out["off"] = jax.jit(lambda p, t: jm.forward(p, t)[0])(jp, tok)
    out["on"] = jax.jit(lambda p, t, c: jm.forward(
        p, t, qcfg=JQ.on(), comp=c)[0])(jp, tok, jcomp)
    chosen = []
    real_top_k = jax.lax.top_k

    def recording(x, k):
        v, i = real_top_k(x, k)
        chosen.append(np.asarray(i))
        return v, i

    jax.lax.top_k = recording
    try:
        logits, cache = jm.prefill(jp, tok, MAX_LEN, cache_dtype=jnp.float32)
    finally:
        jax.lax.top_k = real_top_k
    out["prefill"], out["prefill_choices"], out["decode"] = logits, chosen, []
    for i in range(DECODE_STEPS):
        logits, cache = jm.decode_step(jp, cache, jnp.asarray(nxt[i]))
        out["decode"].append(logits)
    return out


def test_moe_family_forward_prefill_decode_match_jax(moe_ref, monkeypatch):
    """The olmo-1b bounds on the MoE family: forward, prefill and decode at
    TOL on shared routing (each prefill layer's top-k choices equal in both
    packages: the count that differs is 0), the forward's load-balance and
    z losses nonzero."""
    r = moe_ref
    tm, tp, vocab = r["tm"], r["tp"], r["jcfg"].vocab
    tok = torch.from_numpy(r["tokens"])
    with torch.no_grad():
        logits, aux = tm.forward(tp, tok)
        assert logit_rel(logits, r["off"], vocab) < TOL
        assert float(aux["lb_loss"]) > 0 and float(aux["z_loss"]) > 0
        chosen = []
        real = tmoe.top_k
        monkeypatch.setattr(tmoe, "top_k", lambda p, k: (
            lambda v_i: chosen.append(t2n(v_i[1])) or v_i)(real(p, k)))
        logits, cache = tm.prefill(tp, tok, MAX_LEN,
                                   cache_dtype=torch.float32)
        monkeypatch.setattr(tmoe, "top_k", real)
        assert len(chosen) == len(r["prefill_choices"]) == tm.n_rep
        flips = sum(int((a != b).sum())
                    for a, b in zip(chosen, r["prefill_choices"]))
        assert flips == 0, f"{flips} routing choices differ"
        assert logit_rel(logits, r["prefill"], vocab) < TOL
        for i in range(DECODE_STEPS):
            logits, cache = tm.decode_step(
                tp, cache, torch.from_numpy(r["decode_tokens"][i]))
            assert logit_rel(logits, r["decode"][i], vocab) < TOL, i


def test_moe_family_fake_quant_forward_within_stated_bound(moe_ref):
    r = moe_ref
    with torch.no_grad():
        logits, _ = r["tm"].forward(r["tp"], torch.from_numpy(r["tokens"]),
                                    qcfg=TQ.on(), comp=r["tcomp"])
    assert logit_rel(logits, r["on"], r["jcfg"].vocab) < ON_TOL


def _counting_group(calls):
    real = fq_ops.fake_quant_group

    def counting(ws, comps, cands=None):
        calls.append((len(ws), cands))
        return real(ws, comps, cands)
    return real, counting


def test_fake_quant_forward_is_one_grouped_k3_call(ref, monkeypatch):
    """A fake-quant forward makes one grouped K3 call (7 stacked units,
    the layer axis as K3's candidate axis); a served forward whose units
    all serve makes none, and one with an unserved unit one call of the
    unserved units."""
    calls = []
    _, counting = _counting_group(calls)
    monkeypatch.setattr(fq_ops, "fake_quant_group", counting)
    tm, tp, tok = ref["tm"], ref["tp"], torch.from_numpy(ref["tokens"])
    tm.forward(tp, tok, qcfg=TQ.on(), comp=ref["tcomp"])
    assert calls == [(7, ref["tcfg"].n_layers)]
    calls.clear()
    served, n = tlc.attach_serve_artifacts(tm, tp, ref["tcomp"])
    assert n == 7
    tm.forward(tp, tok, qcfg=TQ.serve(), comp=served)
    assert calls == []
    partial = tlc.set_codebook(ref["tcomp"], "blocks/g0/attn/wk", [])
    served, n = tlc.attach_serve_artifacts(tm, tp, partial)
    assert n == 6
    tm.forward(tp, tok, qcfg=TQ.serve(), comp=served)
    assert calls == [(1, ref["tcfg"].n_layers)]


def test_stacked_fake_quant_is_per_layer_semantics(ref):
    """Candidate j of the stacked call equals `fake_quant_weight` of layer
    j under layer j's comp, and the JAX package's, bit for bit."""
    block, comp = ref["tp"]["blocks"]["g0"], ref["tcomp"]["blocks"]["g0"]
    jblock = ref["jp"]["blocks"]["g0"]
    jcomp = ref["jcomp"]["blocks"]["g0"]
    units = tT.block_matmuls(block)
    ws = [block[u.split("/")[0]][u.split("/")[1]] for u in units]
    outs = tqat.fake_quant_weights(ws, [comp[u] for u in units], cands=2)
    for u, w, out in zip(units, ws, outs):
        sub, key = u.split("/")
        for j in range(2):
            cj = {k: v[j] for k, v in comp[u].items()}
            assert torch.equal(out[j], tqat.fake_quant_weight(w[j], cj)), u
            jc = {k: v[j] for k, v in jcomp[u].items()}
            np.testing.assert_array_equal(
                t2n(out[j]), jqat.fake_quant_weight(jblock[sub][key][j], jc))


def test_served_products_equal_exact_matmul_of_artifact(ref, monkeypatch):
    """Each served product is `exact_matmul` of its input and the
    artifact's dequantized weight, bit for bit (bias and activation after
    it), and the served logits agree with the fake-quant forward's and
    with the JAX package's served forward."""
    tm, tp, tok = ref["tm"], ref["tp"], torch.from_numpy(ref["tokens"])
    served, _ = tlc.attach_serve_artifacts(tm, tp, ref["tcomp"])
    seen = []
    real = texport.serve_dense

    def recording(x, art, **kw):
        y = real(x, art, **kw)
        seen.append((x, art, kw, y))
        return y

    for mod in (tA, tT):
        monkeypatch.setattr(mod, "serve_dense", recording)
    logits, _ = tm.forward(tp, tok, qcfg=TQ.serve(), comp=served)
    assert len(seen) == 7 * ref["tcfg"].n_layers
    acts = set()
    for x, art, kw, y in seen:
        w = k2ref.dequantize(art.packed, art.codebook, art.scale,
                             art.block_k)[:art.k_dim]
        want = k2ref.exact_matmul(x.reshape(-1, art.k_dim).float(), w)
        if kw.get("bias") is not None:
            want = want + kw["bias"]
        act = kw.get("activation", "none")
        acts.add(act)
        want = k2ref.ACTIVATIONS[act](want)
        assert torch.equal(y.reshape(-1, art.n_dim), want)
    assert acts == {"none", "silu"}
    fake, _ = tm.forward(tp, tok, qcfg=TQ.on(), comp=ref["tcomp"])
    vocab = ref["jcfg"].vocab
    assert logit_rel(logits, t2n(fake), vocab) < TOL
    assert logit_rel(logits, ref["serve"], vocab) < TOL


def test_straight_through_weight_is_the_artifacts_to_rounding(ref):
    """The fake-quant forward's weight ``wm + (wq - wm)`` (float32, the JAX
    package's straight-through value) is the artifact's dequantized weight
    ``wq`` up to the rounding of that subtraction and addition: within
    ulp(wq - wm) + ulp(wq), pruned and zero weights exactly 0. Why served
    and fake-quant logits agree to float32 ulps, not bit for bit; the
    rounding grows as the projection moves weights farther (k = 4)."""
    tm, tp = ref["tm"], ref["tp"]
    arts, _ = tlc.export_lm_matmuls(tm, tp, ref["tcomp"])

    def ulp(x):
        x = x.abs()
        return torch.nextafter(x, torch.full_like(x, float("inf"))) - x

    def mat(t, layout, shape):
        return (t.reshape(shape[0], -1) if layout == "in_first"
                else t.reshape(-1, shape[-1]))

    n = 0
    for name, w, c, layout in tlc.iter_restricted_units(tm, tp,
                                                        ref["tcomp"]):
        wf = mat(tqat.fake_quant_weight(w, c), layout, w.shape)
        wm = mat(w * c["mask"].float(), layout, w.shape)
        a = arts[name]
        wq = k2ref.dequantize(a.packed, a.codebook, a.scale,
                              a.block_k)[:a.k_dim]
        assert bool(((wf - wq).abs() <= ulp(wq - wm) + ulp(wq)).all()), name
        assert bool((wf[wq == 0] == 0).all()), name
        n += 1
    assert n == 7 * ref["tcfg"].n_layers
