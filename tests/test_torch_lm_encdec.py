"""Port parity for the encoder-decoder family (reduced whisper-large-v3: 2
encoder and 2 decoder layers, d 128, LayerNorm, tanh GELU FFN, sinusoidal
positions, float32 compute), JAX package against `repro_torch` on the same
numpy arrays: forward, loss, prefill + decode with the cross-attention
cache, the k = 4 fake-quant forward, one train step on an ``enc_embeds``
batch, attention at an encoder length that is not a multiple of the key
block, compress → export across the two packages' CLIs, and the serving
engine's refusal.

Tolerances and why (as `test_torch_lm_model.py`'s):
  * forward, loss, prefill, decode, cache leaves, attention: rel 1e-5
    (``TOL``: the same float32 operations in other summation orders);
  * the k = 4 fake-quant forward: rel 1e-3 (``ON_TOL``: the port's products
    are correctly rounded and JAX's are float32 sums, so an activation
    within ~1e-7 of an int8 rounding boundary may take the next code);
  * prefill + decode against the full forward at an encoder length that is
    a block multiple: max abs 1e-4 (the JAX package's own roundtrip test
    holds 1e-3); at a length that is not, the forward's cross-attention
    also attends over the padded keys (zeros, unmasked by the non-causal
    mask, as in the JAX package), decode's does not, and the two differ
    in both packages alike;
  * the train step without QAT: olmo-1b's bounds (loss rel 1e-5, gradient
    rel-L2 1e-5, params abs 2e-4);
  * comp trees, decisions' integers and exported artifacts: equal;
    energies on the JAX package's uniform-trace LUT: rel 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import Shape as JShape
from repro.core import energy_lut as jelut
from repro.core import lm_compress as jlc
from repro.launch import train as jtrain
from repro.models.lm import build_lm as jbuild
from repro.nn import attention as jA
from repro.nn.layers import QuantConfig as JQ
from repro.nn.spec import flatten_with_names as jflat
from repro.nn.spec import init_params as jinit
from repro.pipeline.config import reduced_lm_config as j_reduced_lm
from repro.pipeline.pipeline import Pipeline as JPipeline
from repro.pipeline.plan import CompressionPlan as JPlan
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import Shape as TShape
from repro_torch.core import lm_compress as tlc
from repro_torch.kernels.fake_quant import ops as fq_ops
from repro_torch.launch import train as ttrain
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn import attention as tA
from repro_torch.nn.layers import QuantConfig as TQ
from repro_torch.nn.spec import flatten_with_names as tflat
from repro_torch.nn.spec import init_params as tinit
from repro_torch.nn.spec import params_from_numpy
from repro_torch.pipeline import targets as ttargets
from repro_torch.pipeline.plan import CompressionPlan as TPlan
from repro_torch.serving import ServingEngine

TOL, ON_TOL = 1e-5, 1e-3
B, S, PROMPT, BLOCK = 2, 14, 8, 8
S_ENC, S_ENC_ALIGNED = 20, 24          # 20 is not a multiple of BLOCK
ARCH = "whisper-large-v3"
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


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def wref():
    """The reduced whisper in both packages, JAX's parameters and k = 4
    comp carried across, numpy tokens and frames, and the JAX reference
    outputs."""
    jcfg = jget(ARCH).scaled_down(compute_dtype="float32")
    tcfg = tget(ARCH).scaled_down(compute_dtype="float32")
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    jcomp = jlc.restrict_all_codebooks(jm, jlc.init_lm_comp(jm),
                                       jlc.symmetric_codebook_values(4))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    frames = {n: rng.normal(size=(B, n, jcfg.d_model)).astype(np.float32)
              for n in (S_ENC, S_ENC_ALIGNED)}
    out = dict(jcfg=jcfg, jm=jm, tm=tm, jp=jp, tp=j2t(jp), jcomp=jcomp,
               tcomp=j2t(jcomp), tokens=tokens, frames=frames)
    tok, fr = jnp.asarray(tokens), jnp.asarray(frames[S_ENC])
    kw = dict(q_block=BLOCK, kv_block=BLOCK)
    out["off"] = jax.jit(lambda p, t, f: jm.forward(
        p, t, enc_embeds=f, **kw)[0])(jp, tok, fr)
    out["on"] = jax.jit(lambda p, t, f, c: jm.forward(
        p, t, enc_embeds=f, qcfg=JQ.on(), comp=c, **kw)[0])(jp, tok, fr,
                                                            jcomp)
    logits, cache = jax.jit(lambda p, t, f: jm.prefill(
        p, t, S + 4, enc_embeds=f, cache_dtype=jnp.float32, **kw))(
        jp, tok[:, :PROMPT], fr)
    out["prefill"], out["prefill_cache"], out["decode"] = logits, cache, []
    decode = jax.jit(jm.decode_step)
    for t in range(PROMPT, S):
        logits, cache = decode(jp, cache, tok[:, t:t + 1])
        out["decode"].append(logits)
    out["decode_cache"] = cache
    return out


def logit_rel(t_logits, j_logits, vocab):
    t, j = t2n(t_logits), np.asarray(j_logits)
    assert (t[..., vocab:] == -1e30).all()
    return rel(t[..., :vocab], j[..., :vocab])


def test_spec_params_and_comp_tree_match_jax(wref):
    jm, tm = wref["jm"], wref["tm"]
    assert list(jflat(jm.spec)) == list(tflat(tm.spec))
    assert "enc_blocks/attn/wq" in tflat(tm.spec)
    assert "blocks/g0/xattn/wq" in tflat(tm.spec)
    names = tlc.lm_comp_layers(tm)
    assert names == jlc.lm_comp_layers(jm)
    assert len(names) == 16
    assert sum(n.startswith("enc_blocks/") for n in names) == 6
    jc, tc = jflat(jax.device_get(wref["jcomp"])), tflat(
        tlc.restrict_all_codebooks(tm, tlc.init_lm_comp(tm, device="cpu"),
                                   tlc.symmetric_codebook_values(4)))
    assert list(jc) == list(tc)
    for name, v in jc.items():
        np.testing.assert_array_equal(t2n(tc[name]), v, err_msg=name)


@pytest.mark.parametrize("blocks", [(BLOCK, BLOCK), (512, 512)])
def test_forward_matches_jax(wref, blocks):
    """Encoder length 20: padded to 24 by (8, 8) blocks, to 512 by the
    defaults (the padded keys take part in both packages alike)."""
    tok, fr = wref["tokens"], wref["frames"][S_ENC]
    qb, kb = blocks
    logits, aux = wref["tm"].forward(wref["tp"], torch.from_numpy(tok),
                                     enc_embeds=torch.from_numpy(fr),
                                     q_block=qb, kv_block=kb)
    want = wref["off"] if blocks == (BLOCK, BLOCK) else wref["jm"].forward(
        wref["jp"], jnp.asarray(tok), enc_embeds=jnp.asarray(fr))[0]
    assert logit_rel(logits, want, wref["jcfg"].vocab) < TOL
    assert float(aux["lb_loss"]) == 0.0


def test_forward_needs_enc_embeds(wref):
    with pytest.raises(ValueError, match="enc_embeds"):
        wref["tm"].forward(wref["tp"], torch.from_numpy(wref["tokens"]))


def test_loss_matches_jax(wref):
    tok, fr = wref["tokens"], wref["frames"][S_ENC]
    kw = dict(q_block=BLOCK, kv_block=BLOCK)
    jl, _ = jax.jit(lambda p, b: wref["jm"].loss(p, b, **kw))(
        wref["jp"], {"tokens": jnp.asarray(tok[:, :-1]),
                     "labels": jnp.asarray(tok[:, 1:]),
                     "enc_embeds": jnp.asarray(fr)})
    with torch.no_grad():
        tl, _ = wref["tm"].loss(wref["tp"], {
            "tokens": torch.from_numpy(tok[:, :-1]),
            "labels": torch.from_numpy(tok[:, 1:]),
            "enc_embeds": torch.from_numpy(fr)}, **kw)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)


def test_prefill_and_decode_match_jax(wref):
    tm, tp, vocab = wref["tm"], wref["tp"], wref["jcfg"].vocab
    tok = torch.from_numpy(wref["tokens"])
    fr = torch.from_numpy(wref["frames"][S_ENC])
    logits, cache = tm.prefill(tp, tok[:, :PROMPT], S + 4, enc_embeds=fr,
                               cache_dtype=torch.float32, q_block=BLOCK,
                               kv_block=BLOCK)
    assert logit_rel(logits, wref["prefill"], vocab) < TOL
    spec = tm.cache_spec(B, S + 4, torch.float32, cross_len=S_ENC)
    want = wref["prefill_cache"]["groups"]["g0"]
    assert set(cache["groups"]["g0"]) == set(want) == {"k", "v", "xk", "xv"}
    for key in want:
        assert tuple(spec["groups"]["g0"][key].shape) == tuple(
            cache["groups"]["g0"][key].shape) == want[key].shape
        assert cache["groups"]["g0"][key].dtype == torch.float32
        assert rel(t2n(cache["groups"]["g0"][key]), want[key]) < TOL, key
    for i, t in enumerate(range(PROMPT, S)):
        logits, cache = tm.decode_step(tp, cache, tok[:, t:t + 1])
        assert logit_rel(logits, wref["decode"][i], vocab) < TOL, t
    for key, v in wref["decode_cache"]["groups"]["g0"].items():
        assert rel(t2n(cache["groups"]["g0"][key]), v) < TOL, key
    np.testing.assert_array_equal(t2n(cache["pos"]),
                                  wref["decode_cache"]["pos"])


def test_prefill_and_decode_reproduce_the_forward(wref):
    """JAX's roundtrip contract at a block-multiple encoder length, and at
    a length that is not one the padded keys' gap, the JAX package's own;
    a bfloat16 cache keeps its dtype in the cross K/V leaves."""
    tm, tp, vocab = wref["tm"], wref["tp"], wref["jcfg"].vocab
    tok = torch.from_numpy(wref["tokens"])
    kw = dict(q_block=BLOCK, kv_block=BLOCK)
    gaps = {}
    for n in (S_ENC_ALIGNED, S_ENC):
        fr = torch.from_numpy(wref["frames"][n])
        full, _ = tm.forward(tp, tok, enc_embeds=fr, **kw)
        lg, cache = tm.prefill(tp, tok[:, :PROMPT], S + 4, enc_embeds=fr,
                               cache_dtype=torch.float32, **kw)
        errs = [float((lg[..., :vocab] - full[:, :PROMPT, :vocab])
                      .abs().max())]
        for t in range(PROMPT, S):
            ld, cache = tm.decode_step(tp, cache, tok[:, t:t + 1])
            errs.append(float((ld[:, 0, :vocab] - full[:, t, :vocab])
                              .abs().max()))
        gaps[n] = max(errs)
    assert gaps[S_ENC_ALIGNED] < 1e-4
    jm, jp = wref["jm"], wref["jp"]
    fr = jnp.asarray(wref["frames"][S_ENC])
    _, jcache = jm.prefill(jp, jnp.asarray(wref["tokens"][:, :PROMPT]),
                           S + 4, enc_embeds=fr, cache_dtype=jnp.float32, **kw)
    jd, _ = jm.decode_step(jp, jcache,
                           jnp.asarray(wref["tokens"][:, PROMPT:PROMPT + 1]))
    jgap = float(jnp.max(jnp.abs(jd[:, 0, :vocab]
                                 - wref["off"][:, PROMPT, :vocab])))
    assert gaps[S_ENC] > 100 * gaps[S_ENC_ALIGNED] and jgap > 1e-2
    _, bcache = tm.prefill(tp, tok[:, :PROMPT], S + 4,
                           enc_embeds=torch.from_numpy(wref["frames"][S_ENC]),
                           cache_dtype=torch.bfloat16, **kw)
    assert bcache["groups"]["g0"]["xk"].dtype == torch.bfloat16


@pytest.mark.parametrize("s_kv", [S_ENC, S_ENC_ALIGNED, 5])
def test_attention_over_given_kv_matches_jax(wref, s_kv):
    """Cross-attention (keys and values given, non-causal, no RoPE) and
    the encoder's self-attention at lengths that are and are not multiples
    of the key block, against the JAX package; one query over the same
    keys in decode."""
    jcfg = wref["jcfg"]
    dims_j, dims_t = jcfg.enc_attn_dims(), wref["tm"].cfg.enc_attn_dims()
    assert not dims_t.causal and dims_t.rope_theta == 0
    jp = {k: v[0] for k, v in wref["jp"]["blocks"]["g0"]["xattn"].items()}
    tp = {k: v[0] for k, v in wref["tp"]["blocks"]["g0"]["xattn"].items()}
    rng = np.random.default_rng(s_kv)
    x = rng.normal(size=(B, 6, jcfg.d_model)).astype(np.float32)
    hkv, hd = dims_t.n_kv_heads, dims_t.head_dim
    k, v = (rng.normal(size=(B, s_kv, hkv, hd)).astype(np.float32)
            for _ in range(2))
    jy = jA.apply_attention(jp, x, dims_j, kv=(k, v), q_block=BLOCK,
                            kv_block=BLOCK)
    ty = tA.apply_attention(tp, torch.from_numpy(x), dims_t,
                            kv=(torch.from_numpy(k), torch.from_numpy(v)),
                            q_block=BLOCK, kv_block=BLOCK)
    assert rel(t2n(ty), jy) < TOL
    xs = rng.normal(size=(B, s_kv, jcfg.d_model)).astype(np.float32)
    jy = jA.apply_attention(jp, xs, dims_j, q_block=BLOCK, kv_block=BLOCK)
    ty = tA.apply_attention(tp, torch.from_numpy(xs), dims_t, q_block=BLOCK,
                            kv_block=BLOCK)
    assert rel(t2n(ty), jy) < TOL
    jd, _ = jA.apply_attention_decode(jp, x[:, :1], {}, 3, dims_j,
                                      cross_kv=(k, v))
    td, cache = tA.apply_attention_decode(
        tp, torch.from_numpy(x[:, :1]), {}, 3, dims_t,
        cross_kv=(torch.from_numpy(k), torch.from_numpy(v)))
    assert rel(t2n(td), jd) < TOL and cache == {}


def _counting_group(monkeypatch):
    calls = []
    real = fq_ops.fake_quant_group

    def counting(ws, comps, cands=None):
        calls.append((len(ws), cands))
        return real(ws, comps, cands)

    monkeypatch.setattr(fq_ops, "fake_quant_group", counting)
    return calls


def test_fake_quant_forward_within_bound_in_one_k3_call(wref, monkeypatch):
    """The k = 4 fake-quant forward at ``ON_TOL``; the encoder's 6 stacked
    units join the decoder's 10 in one grouped K3 call (the layer axis as
    K3's candidate axis); served, no call."""
    calls = _counting_group(monkeypatch)
    tm, tp = wref["tm"], wref["tp"]
    tok = torch.from_numpy(wref["tokens"])
    fr = torch.from_numpy(wref["frames"][S_ENC])
    kw = dict(q_block=BLOCK, kv_block=BLOCK, enc_embeds=fr)
    logits, _ = tm.forward(tp, tok, qcfg=TQ.on(), comp=wref["tcomp"], **kw)
    assert logit_rel(logits, wref["on"], wref["jcfg"].vocab) < ON_TOL
    assert calls == [(16, 2)]
    calls.clear()
    served, n = tlc.attach_serve_artifacts(tm, tp, wref["tcomp"])
    assert n == 16 and all("serve" in c
                           for c in served["enc_blocks"].values())
    served_logits, _ = tm.forward(tp, tok, qcfg=TQ.serve(), comp=served,
                                  **kw)
    assert calls == []
    assert logit_rel(served_logits, logits, wref["jcfg"].vocab) < TOL


def test_train_step_with_enc_embeds_matches_jax(wref):
    tok, fr = wref["tokens"], wref["frames"][S_ENC]
    lr = 1e-3
    jcfg = jtrain.StepConfig(qat=False, with_comp=True, remat=False,
                             q_block=BLOCK, kv_block=BLOCK, lr=lr)
    jstate = {"params": wref["jp"],
              "opt": jtrain.make_optimizer(jcfg).init(wref["jp"])}
    jstate, jmet = jax.jit(jtrain.make_train_step(wref["jm"], jcfg))(
        jstate, {"tokens": jnp.asarray(tok[:, :-1]),
                 "labels": jnp.asarray(tok[:, 1:]),
                 "enc_embeds": jnp.asarray(fr)}, wref["jcomp"])
    jstate = jax.device_get(jstate)
    tcfg = ttrain.StepConfig(qat=False, with_comp=True, remat=True,
                             q_block=BLOCK, kv_block=BLOCK, lr=lr)
    tp = wref["tp"]
    tstate, tmet = ttrain.make_train_step(wref["tm"], tcfg)(
        {"params": tp, "opt": ttrain.make_optimizer(tcfg).init(tp)},
        {"tokens": torch.from_numpy(tok[:, :-1]),
         "labels": torch.from_numpy(tok[:, 1:]),
         "enc_embeds": torch.from_numpy(fr)}, wref["tcomp"])
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    jmu, tmu = jflat(jstate["opt"]["mu"]), tflat(tstate["opt"]["mu"])
    assert list(jmu) == list(tmu)
    for name in jmu:
        assert rel(t2n(tmu[name]), jmu[name]) < 1e-5, name
    assert float(np.abs(np.asarray(jmu["enc_blocks/attn/wq"])).max()) > 0
    jpar, tpar = jflat(jstate["params"]), tflat(tstate["params"])
    for name in jpar:
        np.testing.assert_allclose(t2n(tpar[name]), np.asarray(jpar[name]),
                                   rtol=0, atol=2e-4, err_msg=name)
    # the VLM prefix is ported: a batch with
    # prefix_embeds trains a VLM, its loss that of the forward's trailing
    # token positions (held to JAX's in tests/test_torch_lm_vlm.py)
    vm = tbuild(tget("internvl2-26b").scaled_down(compute_dtype="float32"))
    vp = tinit(0, vm.spec, "cpu")
    vtok = torch.from_numpy(tok[:, :9])
    prefix = torch.from_numpy(fr[:, :vm.cfg.prefix_len])
    vcfg = ttrain.StepConfig(qat=False, with_comp=False, remat=False)
    vbatch = {"tokens": vtok[:, :-1], "labels": vtok[:, 1:],
              "prefix_embeds": prefix}
    with torch.no_grad():
        want, _ = vm.loss(vp, vbatch)
    _, vmet = ttrain.make_train_step(vm, vcfg)(
        {"params": vp, "opt": ttrain.make_optimizer(vcfg).init(vp)}, vbatch)
    assert np.isfinite(float(vmet["loss"]))
    np.testing.assert_allclose(float(vmet["loss"]), float(want), rtol=1e-6)


def test_batch_and_cache_specs_match_jax(wref):
    assert ttrain.WHISPER_DECODER_LEN == jtrain.WHISPER_DECODER_LEN == 448
    for kind, seq in (("train", 1500), ("prefill", 300), ("decode", 1500)):
        js, ts = JShape("c", kind, seq, 4), TShape("c", kind, seq, 4)
        if kind != "decode":
            jb = jtrain.batch_specs(wref["jcfg"], js)
            tb = ttrain.batch_specs(wref["tm"].cfg, ts)
            assert list(tb) == list(jb)
            for k in jb:
                assert tuple(tb[k].shape) == jb[k].shape, k
                assert str(tb[k].dtype).replace("torch.", "") == \
                    str(jb[k].dtype)
        jc = jax.tree.leaves(jtrain.decode_cache_specs(wref["jm"], js))
        tc = ttrain.decode_cache_specs(wref["tm"], ts)
        leaves = [tc["groups"]["g0"][k] for k in sorted(tc["groups"]["g0"])]
        assert sorted(tuple(x.shape) for x in leaves + [tc["pos"]]) == \
            sorted(x.shape for x in jc)


@pytest.fixture(scope="module")
def jplans(tmp_path_factory):
    """The JAX package's reduced-whisper pipeline (k = 4) through schedule
    and through export, each plan saved."""
    base = tmp_path_factory.mktemp("whisper_plans")
    pipe = JPipeline(j_reduced_lm(ARCH))
    pipe.run_until("schedule").save(base / "schedule")
    pipe.run_until("export").save(base / "export")
    lut = torch.from_numpy(np.array(jelut.uniform_trace_lut()))
    return base, lut


def test_compress_and_export_across_the_clis(jplans, monkeypatch, tmp_path,
                                             capsys):
    """``python -m repro_torch export --plan-in`` on the JAX package's
    schedule plan gives its export plan's artifacts byte for byte; the
    port's ``compress --target lm --arch whisper-large-v3`` restricts the
    same 16 units (32 layer slices) and exports all of them."""
    from repro_torch.pipeline import cli

    base, lut = jplans
    monkeypatch.setattr(ttargets, "uniform_trace_lut",
                        lambda device="cpu": lut.to(device))
    assert cli.main(["export", "--plan-in", str(base / "schedule"),
                     "--device", "cpu", "--quiet",
                     "--plan-out", str(tmp_path / "t_export")]) == 0
    got, want = TPlan.load(tmp_path / "t_export"), JPlan.load(
        base / "export")
    assert list(got.artifacts) == list(want.artifacts)
    assert len(got.artifacts) == 32
    assert sum(n.startswith("enc_blocks/") for n in got.artifacts) == 12
    for name, art in want.artifacts.items():
        for f in ART_FIELDS:
            np.testing.assert_array_equal(t2n(getattr(got.artifacts[name],
                                                      f)),
                                          np.asarray(getattr(art, f)),
                                          err_msg=f"{name}.{f}")
        for f in ART_META:
            assert getattr(got.artifacts[name], f) == getattr(art, f)
    for key in ("export_layers", "export_weight_bytes_packed", "n_units",
                "energy_before", "energy_after"):
        np.testing.assert_allclose(got.metrics[key], want.metrics[key],
                                   rtol=1e-5, err_msg=key)
    assert got.metrics["n_units"] == 16
    assert cli.main(["compress", "--target", "lm", "--arch", ARCH,
                     "--reduced", "--compress-k", "4", "--device", "cpu",
                     "--quiet", "--plan-out", str(tmp_path / "t_own")]) == 0
    own = TPlan.load(tmp_path / "t_own")
    assert [d["layer"] for d in own.decisions] == \
        [d["layer"] for d in want.decisions]
    assert own.metrics["export_layers"] == 32
    jf, tf = tflat(jax.device_get(want.comp)), tflat(own.comp)
    assert list(jf) == list(tf)
    for name, v in jf.items():
        np.testing.assert_array_equal(t2n(tf[name]), v, err_msg=name)
    capsys.readouterr()


def test_slot_serving_and_chunked_prefill_raise_as_jax(jplans, wref):
    """``serve --plan-in`` of a whisper plan raises JAX's `ValueError`
    (slot-level batching has no chunk path), as do `prefill_chunk` and a
    cross-attention block's chunk step."""
    from repro_torch.pipeline import cli

    base, _ = jplans
    with pytest.raises(ValueError, match="no chunk path for encoder-decoder"):
        cli.main(["serve", "--plan-in", str(base / "export"), "--device",
                  "cpu", "--quiet"])
    with pytest.raises(ValueError, match="no chunk path for encoder-decoder"):
        ServingEngine(wref["tm"], wref["tp"], mode="engine", device="cpu")
    cache = wref["tm"].init_cache(B, 16, torch.float32, S_ENC, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        wref["tm"].prefill_chunk(wref["tp"], cache,
                                 torch.from_numpy(wref["tokens"][:, :4]),
                                 start=torch.zeros(B, dtype=torch.int32))
