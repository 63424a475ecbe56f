"""Port parity for the MoE FFN (`repro_torch.nn.moe`) and the MoE family's
compression and training: reduced phi3.5-moe (2 layers, d 128, 4 experts,
top-2) and moonshot (the same, plus one shared expert), the JAX package
against `repro_torch` on the same numpy arrays.

Shared routing: every comparison first holds both packages' top-k choices
equal (the number of choices that differ is asserted 0 and stated on
failure); the router's float32 logits could differ by an ulp between the
packages and flip a near-tie, which none of these inputs has.

Tolerances and why:
  * `apply_moe` without QAT, its output and aux losses, prefill_chunk and
    decode logits: rel 1e-5 (the same float32 operations, only summation
    orders differ: ~1e-7);
  * with per-expert fake-quant (k = 16, some experts at 4 and 8) or
    served: rel 1e-3 (the port's fake-quant products are correctly rounded,
    JAX's are float32 sums, so an activation within ~1e-7 of an int8
    rounding boundary can quantize one step apart; the olmo-1b bound);
    served against the port's own fake-quant forward: rel 1e-5;
  * kept-dispatch counts, slots, dropped fractions, exported artifacts and
    K3's per-expert values: equal;
  * one train step: the LM QAT bounds of `tests/test_torch_lm_train.py`
    (loss rel 1e-5, Adam moments rel-L2 1e-5 off / 1e-4 on, params abs
    2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import lm_compress as jlc
from repro.core import qat as jqat
from repro.core import routing_stats as jrs
from repro.launch import train as jtrain
from repro.models.lm import build_lm as jbuild
from repro.nn import moe as jmoe
from repro.nn.layers import QuantConfig as JQ
from repro.nn.spec import flatten_with_names as jflat
from repro.nn.spec import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.core import export as texport
from repro_torch.core import lm_compress as tlc
from repro_torch.core import qat as tqat
from repro_torch.core import routing_stats as trs
from repro_torch.kernels.fake_quant import ops as fq_ops
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn import moe as tmoe
from repro_torch.nn.layers import QuantConfig as TQ
from repro_torch.nn.spec import flatten_with_names as tflat
from repro_torch.nn.spec import params_from_numpy

ARCHS = ("phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b")
TOL, ON_TOL = 1e-5, 1e-3
B, S, MAX_LEN, CHUNK = 2, 12, 16, 6
ART_FIELDS = ("packed", "codebook", "scale")


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


def layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def moe_comp(comp, port=False):
    """The ``moe/...`` entries of layer 0 of the stacked group (``port``:
    a port comp tree, whose artifacts are not JAX pytrees)."""
    g0 = tlm._layer(comp["blocks"]["g0"], 0) if port \
        else layer0(comp["blocks"]["g0"])
    return {k: v for k, v in g0.items() if k.startswith("moe/")}


def restricted(jm):
    """k = 16 everywhere; expert 1 of w_up at k = 4 in layer 0, expert 2 of
    w_down at k = 8 in every layer, layer 1's experts of w_gate at k = 4."""
    comp = jlc.restrict_all_codebooks(jm, jlc.init_lm_comp(jm),
                                      jlc.symmetric_codebook_values(16))
    comp = jlc.set_codebook(comp, "blocks/g0/moe/w_up",
                            jlc.symmetric_codebook_values(4), layer=0,
                            expert=1)
    comp = jlc.set_codebook(comp, "blocks/g0/moe/w_down",
                            jlc.symmetric_codebook_values(8), expert=2)
    return jlc.set_codebook(comp, "blocks/g0/moe/w_gate",
                            jlc.symmetric_codebook_values(4), layer=1)


@pytest.fixture(scope="module", params=ARCHS)
def moe(request):
    arch = request.param
    jm = jbuild(jget(arch).scaled_down(compute_dtype="float32"))
    tm = tbuild(tget(arch).scaled_down(compute_dtype="float32"))
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    jc = restricted(jm)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, jm.cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jm.cfg.vocab, (B, S + 4)).astype(np.int32)
    return dict(arch=arch, jm=jm, tm=tm, jp=jp, tp=j2t(jp), jc=jc,
                tc=j2t(jc), x=x, toks=toks, dims=jm.cfg.moe_dims(),
                tdims=tm.cfg.moe_dims())


def choices(m, x, params):
    """(JAX's, the port's) top-k expert choices for x on the router."""
    router = np.array(params["router"])
    jp = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, je = jax.lax.top_k(jp, m["dims"].top_k)
    tp = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(router), -1)
    _, te = tmoe.top_k(tp, m["dims"].top_k)
    return np.asarray(je), t2n(te)


def assert_shared_routing(m, x, params):
    je, te = choices(m, x, params)
    flips = int((je != te).sum())
    assert flips == 0, f"{flips} of {je.size} routing choices differ"


def run_both(m, x, qcfg_j, qcfg_t, jcomp, tcomp, jparams=None):
    """apply_moe of layer 0 in both packages, with each one's kept-count
    collector events: ((y, aux, events) JAX, (y, aux, events) port)."""
    jparams = layer0(m["jp"]["blocks"]["g0"]["moe"]) if jparams is None \
        else jparams
    tparams = j2t(jparams)
    jev, tev = [], []
    with jrs.collecting(lambda k, n, v: jev.append(np.asarray(v))):
        jy, jaux = jmoe.apply_moe(jparams, jnp.asarray(x), m["dims"],
                                  qcfg=qcfg_j, comp=jcomp)
    with torch.no_grad(), trs.collecting(
            lambda k, n, v: tev.append(t2n(v))):
        ty, taux = tmoe.apply_moe(tparams, torch.from_numpy(x), m["tdims"],
                                  qcfg=qcfg_t, comp=tcomp)
    return (np.asarray(jy), jaux, jev), (t2n(ty), taux, tev)


# ---------------------------------------------------------------- basics


def test_capacity_and_spec_match_jax(moe):
    for s in (1, 7, 12, 64, 256, 1000):
        assert tmoe.capacity(moe["tdims"], s) == jmoe.capacity(moe["dims"], s)
    js, ts = jmoe.make_moe_spec(moe["dims"]), tmoe.make_moe_spec(moe["tdims"])
    assert list(js) == list(ts)
    for k in js:
        assert tuple(js[k].shape) == tuple(ts[k].shape), k
        assert tuple(js[k].axes) == tuple(ts[k].axes), k
    # the dispatch hook (a layout constraint in JAX) is set, leaves the
    # values alone, and is cleared
    tparams = j2t(layer0(moe["jp"]["blocks"]["g0"]["moe"]))
    x = moe["x"]
    with torch.no_grad():
        want, _ = tmoe.apply_moe(tparams, torch.from_numpy(x),
                                 moe["tdims"])
    kinds = []
    token = tmoe.set_dispatch_constraint(
        lambda t, kind: kinds.append((kind, tuple(t.shape))) or t)
    assert tmoe.dispatch_constraint() is not None
    with torch.no_grad():
        got, _ = tmoe.apply_moe(tparams, torch.from_numpy(x),
                                moe["tdims"])
    tmoe.reset_dispatch_constraint(token)
    assert tmoe.dispatch_constraint() is None
    assert [k for k, _ in kinds] == ["scatter", "expert"]
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_takes_the_lower_index_on_ties(k):
    rows = np.array([[0.25, 0.25, 0.25, 0.25],
                     [0.1, 0.4, 0.1, 0.4],
                     [0.3, 0.2, 0.3, 0.2],
                     [0.0, 0.5, 0.5, 0.0],
                     [0.7, 0.1, 0.1, 0.1]], np.float32)
    rand = np.random.default_rng(0).integers(0, 3, (64, 8)).astype(
        np.float32) / 4   # many exact ties
    for probs in (rows, rand):
        jv, je = jax.lax.top_k(jnp.asarray(probs), k)
        tv, te = tmoe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(t2n(te), np.asarray(je))
        np.testing.assert_array_equal(t2n(tv), np.asarray(jv))
    _, te = tmoe.top_k(torch.from_numpy(rows), k)
    assert t2n(te)[0].tolist() == list(range(k))       # all tied: 0, 1, ..


# ---------------------------------------------------------------- apply_moe


def test_apply_moe_off_matches_jax(moe):
    x = moe["x"]
    assert_shared_routing(moe, x, layer0(moe["jp"]["blocks"]["g0"]["moe"]))
    (jy, jaux, jev), (ty, taux, tev) = run_both(
        moe, x, JQ.off(), TQ.off(), None, None)
    assert rel(ty, jy) < TOL
    assert set(taux) == set(jaux) == {"lb_loss", "z_loss", "dropped_frac"}
    for key in taux:
        assert taux[key].dtype == torch.float32 and taux[key].ndim == 0
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=TOL, atol=1e-7, err_msg=key)
    assert len(tev) == len(jev) == 1
    np.testing.assert_array_equal(tev[0], jev[0])
    assert tev[0].sum() == B * S * moe["dims"].top_k \
        - round(float(taux["dropped_frac"]) * B * S * moe["dims"].top_k)


def test_apply_moe_drops_match_jax(moe):
    """A router that sends every token to expert 0 first overflows its
    capacity: the same tokens drop in both packages (their slots hold the
    earlier tokens of the row), and the same fraction is reported."""
    jparams = dict(layer0(moe["jp"]["blocks"]["g0"]["moe"]))
    router = np.array(jparams["router"])
    router[:, 0] += 0.5 * np.sign(moe["x"].sum(axis=(0, 1)))
    jparams["router"] = jnp.asarray(router)
    x = moe["x"] + 2.0                       # a common direction: hot expert
    assert_shared_routing(moe, x, jparams)
    (jy, jaux, jev), (ty, taux, tev) = run_both(
        moe, x, JQ.off(), TQ.off(), None, None, jparams=jparams)
    assert float(jaux["dropped_frac"]) > 0
    np.testing.assert_allclose(float(taux["dropped_frac"]),
                               float(jaux["dropped_frac"]), rtol=1e-6)
    np.testing.assert_array_equal(tev[0], jev[0])
    assert rel(ty, jy) < TOL


@pytest.mark.parametrize("mode", ["fake_quant", "serve"])
def test_apply_moe_quantized_matches_jax(moe, mode, monkeypatch):
    """Per-expert fake-quant (each expert its own scales and codebook, as
    JAX's vmap), and the serve path: one LUT GEMM an (expert, matrix) on
    the plain K2 (the shared expert's matrices too), from each expert's
    slice of the stacked artifact, against JAX's served forward."""
    x = moe["x"]
    assert_shared_routing(moe, x, layer0(moe["jp"]["blocks"]["g0"]["moe"]))
    if mode == "fake_quant":
        jq, tq = JQ.on(), TQ.on()
        jcomp, tcomp = moe_comp(moe["jc"]), moe_comp(moe["tc"])
    else:
        jq, tq = JQ.serve(use_ref_kernel=True), TQ.serve()
        jcomp = moe_comp(jlc.attach_serve_artifacts(
            moe["jm"], moe["jp"], moe["jc"])[0])
        tcomp = moe_comp(tlc.attach_serve_artifacts(
            moe["tm"], moe["tp"], moe["tc"])[0], port=True)
    calls = []
    real = texport.lut_matmul_fused
    monkeypatch.setattr(texport, "lut_matmul_fused",
                        lambda x2d, *a, **kw: calls.append(x2d.shape)
                        or real(x2d, *a, **kw))
    (jy, jaux, jev), (ty, taux, tev) = run_both(moe, x, jq, tq, jcomp,
                                                tcomp)
    assert rel(ty, jy) < ON_TOL
    np.testing.assert_array_equal(tev[0], jev[0])
    for key in taux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=TOL, atol=1e-7, err_msg=key)
    e, cap = moe["dims"].n_experts, tmoe.capacity(moe["tdims"], S)
    shared = 3 if moe["dims"].n_shared else 0
    if mode == "fake_quant":
        assert not calls
        return
    assert len(calls) == 3 * e + shared
    assert calls[:3 * e] == [(B * cap, tq_k) for tq_k in
                             [moe["dims"].d_model] * 2 * e
                             + [texport.x_width(moe["dims"].d_ff)] * e]
    # served against the port's own fake-quant forward
    with torch.no_grad():
        fq, _ = tmoe.apply_moe(j2t(layer0(moe["jp"]["blocks"]["g0"]["moe"])),
                               torch.from_numpy(x), moe["tdims"],
                               qcfg=TQ.on(), comp=moe_comp(moe["tc"]))
    assert rel(ty, t2n(fq)) < TOL


@pytest.mark.parametrize("qat", [False, True])
def test_batch_invariant_rows_do_not_depend_on_batch_mates(moe, qat):
    """Under `QuantConfig.batch_invariant` (the serving engine) each row's
    routing, slots, fake-quantized activations and products are its own:
    a batch of rows equals each row run alone, bit for bit."""
    params = j2t(layer0(moe["jp"]["blocks"]["g0"]["moe"]))
    q = TQ(enabled=qat, batch_invariant=True)
    comp = moe_comp(moe["tc"]) if qat else None
    x = torch.from_numpy(moe["x"])
    with torch.no_grad():
        both, _ = tmoe.apply_moe(params, x, moe["tdims"], qcfg=q, comp=comp)
        for r in range(B):
            alone, _ = tmoe.apply_moe(params, x[r:r + 1], moe["tdims"],
                                      qcfg=q, comp=comp)
            assert torch.equal(both[r:r + 1], alone), r


# ------------------------------------------------------------- K3 entries


def test_expert_units_take_the_models_one_k3_call(moe, monkeypatch):
    """A fake-quant forward makes one grouped K3 call: the stacked
    attention units with 2 layers as candidates and each expert unit with
    2 layers x 4 experts, every (layer, expert) slice equal to JAX's
    vmapped `fake_quant_weight` of it."""
    calls = []
    real = fq_ops.fake_quant_group
    monkeypatch.setattr(fq_ops, "fake_quant_group",
                        lambda ws, comps, cands=None: calls.append(
                            (len(ws), list(cands)))
                        or real(ws, comps, cands))
    tm, tp, tc = moe["tm"], moe["tp"], moe["tc"]
    weff = tm._fake_quant_units(tp, tc, TQ.on())
    n_rep, e = tm.n_rep, moe["dims"].n_experts
    n_att = 4
    n_shared = 3 if moe["dims"].n_shared else 0
    assert calls == [(n_att + 3 + n_shared,
                      [n_rep] * n_att + [n_rep * e] * 3 + [n_rep] * n_shared)]
    block, comp = moe["jp"]["blocks"]["g0"], moe["jc"]["blocks"]["g0"]
    for key in tlc.MOE_EXPERT_KEYS:
        got = t2n(weff["blocks"]["g0"][f"moe/{key}"])
        c = comp[f"moe/{key}"]
        for li in range(n_rep):
            want = jax.vmap(jqat.fake_quant_weight)(
                block["moe"][key][li],
                {ck: c[ck][li] for ck in ("mask", "codebook", "codebook_k")})
            np.testing.assert_array_equal(got[li], np.asarray(want),
                                          err_msg=f"{key}[{li}]")


def test_expert_entries_split_past_the_candidate_limit(moe, monkeypatch):
    """Past K3's candidate limit an expert unit splits into entries of
    whole layers (contiguous slices); the values do not change."""
    tm, tp, tc = moe["tm"], moe["tp"], moe["tc"]
    whole = tm._fake_quant_units(tp, tc, TQ.on())
    calls = []
    real = fq_ops.fake_quant_group
    monkeypatch.setattr(fq_ops, "fake_quant_group",
                        lambda ws, comps, cands=None: calls.append(
                            list(cands)) or real(ws, comps, cands))
    monkeypatch.setattr(tlm, "MAX_CANDIDATES", moe["dims"].n_experts)
    split = tm._fake_quant_units(tp, tc, TQ.on())
    e = moe["dims"].n_experts
    assert calls[0].count(e) == 3 * tm.n_rep
    for key in tflat(whole):
        assert torch.equal(tflat(split)[key], tflat(whole)[key]), key


def test_grouped_call_takes_one_candidate_count_an_entry():
    rng = np.random.default_rng(3)
    w1 = torch.from_numpy(rng.standard_normal((3, 5, 6)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    c1 = tqat.identity_comp((5, 6), device="cpu")
    c1 = {**c1, "codebook": torch.stack([c1["codebook"]] * 3),
          "codebook_k": torch.tensor([0, 3, 5], dtype=torch.int32)}
    c1["codebook"][:, :5] = torch.tensor([-60, -20, 0, 20, 60])
    c2 = tqat.identity_comp((5, 7), device="cpu")
    got = tqat.fake_quant_weights([w1, w2], [c1, c2], [3, None])
    want1 = tqat.fake_quant_weights([w1], [c1], 3)[0]
    want2 = tqat.fake_quant_weights([w2], [c2])[0]
    assert torch.equal(got[0], want1) and torch.equal(got[1], want2)
    with pytest.raises(ValueError, match="2 weights but 1 candidate"):
        fq_ops.check_group([w1, w2], [c1, c2], [3])
    with pytest.raises(ValueError, match="cands must be an int"):
        fq_ops.check_group([w1], [c1], [300])
    with pytest.raises(ValueError, match="group entry 0"):
        fq_ops.check_group([w1], [c1], [4])


# ------------------------------------------------------- model paths


def test_prefill_chunk_and_decode_match_jax(moe):
    """Two prefill chunks then decode steps against JAX's prefill_chunk and
    decode_step at the same chunking (a capacity depends on the call's
    length, so chunked and one-shot prefills can drop different tokens;
    the comparison holds both packages to the same calls)."""
    jm, tm, jp, tp = moe["jm"], moe["tm"], moe["jp"], moe["tp"]
    toks, vocab = moe["toks"], jm.cfg.vocab
    jcache = jm.init_cache(B, MAX_LEN, jnp.float32)
    tcache = tm.init_cache(B, MAX_LEN, torch.float32, device="cpu")
    with torch.no_grad():
        for c0 in range(0, S, CHUNK):
            start = np.full((B,), c0, np.int32)
            jl, jcache = jm.prefill_chunk(
                jp, jcache, jnp.asarray(toks[:, c0:c0 + CHUNK]),
                start=jnp.asarray(start))
            tl, tcache = tm.prefill_chunk(
                tp, tcache, torch.from_numpy(toks[:, c0:c0 + CHUNK]),
                start=torch.from_numpy(start))
            assert rel(t2n(tl)[..., :vocab], np.asarray(jl)[..., :vocab]) \
                < TOL, c0
        for t in range(S, S + 4):
            jl, jcache = jm.decode_step(jp, jcache,
                                        jnp.asarray(toks[:, t:t + 1]))
            tl, tcache = tm.decode_step(tp, tcache,
                                        torch.from_numpy(toks[:, t:t + 1]))
            assert rel(t2n(tl)[..., :vocab], np.asarray(jl)[..., :vocab]) \
                < TOL, t
    for key, v in tflat(tcache).items():
        np.testing.assert_allclose(t2n(v), np.asarray(jflat(jcache)[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("qat,grad_tol", [(False, 1e-5), (True, 1e-4)])
def test_train_step_matches_jax(moe, qat, grad_tol):
    """One `make_train_step` step (loss = ce + 0.01 lb + 1e-3 z) against
    JAX's from the same params, per-expert comp and batch."""
    jm, tm, jp, tp, jc, tc = (moe[k] for k in ("jm", "tm", "jp", "tp", "jc",
                                               "tc"))
    toks = moe["toks"]
    kw = dict(qat=qat, with_comp=True, remat=False, q_block=8, kv_block=8,
              lr=1e-3)
    jcfg, tcfg = jtrain.StepConfig(**kw), ttrain.StepConfig(**kw)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(toks[:, 1:])}
    jstate, jmet = jax.jit(jtrain.make_train_step(jm, jcfg))(
        {"params": jp, "opt": jtrain.make_optimizer(jcfg).init(jp)}, jb, jc)
    jstate = jax.device_get(jstate)
    tstate, tmet = ttrain.make_train_step(tm, tcfg)(
        {"params": tp, "opt": ttrain.make_optimizer(tcfg).init(tp)}, tb, tc)
    assert set(tmet) == set(jmet)
    assert float(tmet["lb_loss"]) > 0 and float(tmet["z_loss"]) > 0
    for k in tmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    jmu, tmu = jflat(jstate["opt"]["mu"]), tflat(tstate["opt"]["mu"])
    assert list(jmu) == list(tmu)
    for name in jmu:
        a, b = np.asarray(tmu[name].numpy(), np.float64), \
            np.asarray(jmu[name], np.float64)
        assert np.linalg.norm(a - b) <= grad_tol * max(np.linalg.norm(b),
                                                      1e-30), name
    jpar, tpar = jflat(jstate["params"]), tflat(tstate["params"])
    for name in jpar:
        np.testing.assert_allclose(tpar[name].numpy(), np.asarray(jpar[name]),
                                   rtol=0, atol=2e-4, err_msg=name)


# ----------------------------------------------------------- export


def test_expert_export_matches_jax(moe):
    """Per-(layer, expert) slices: names, layouts, artifacts byte-identical
    to JAX's, `lut_parity_report` over expert slices, and the stacked serve
    artifacts equal to JAX's leaf for leaf."""
    jm, tm, jp, tp, jc, tc = (moe[k] for k in ("jm", "tm", "jp", "tp", "jc",
                                               "tc"))
    jwalk = [(n, lay) for n, _, _, lay in jlc.iter_eligible_units(jm, jp, jc)]
    twalk = [(n, lay) for n, _, _, lay in tlc.iter_eligible_units(tm, tp, tc)]
    assert twalk == jwalk
    e = moe["dims"].n_experts
    assert sum("[e" in n for n, _ in twalk) == 3 * e * tm.n_rep
    assert "blocks/g0/moe/w_gate[1][e2]" in dict(twalk)
    jarts, jskips = jlc.export_lm_matmuls(jm, jp, jc)
    tarts, tskips = tlc.export_lm_matmuls(tm, tp, tc)
    assert list(tarts) == list(jarts) and tskips == jskips == []
    for name, a in tarts.items():
        for f in ART_FIELDS:
            np.testing.assert_array_equal(t2n(getattr(a, f)),
                                          np.asarray(getattr(jarts[name], f)),
                                          err_msg=f"{name}.{f}")
    checked = tlc.lut_parity_report(tm, tp, tc, tarts,
                                    check_units=len(tarts))
    assert len(checked) == len(tarts) and max(checked.values()) < 1e-5
    jatt, jn = jlc.attach_serve_artifacts(jm, jp, jc)
    tatt, tn = tlc.attach_serve_artifacts(tm, tp, tc)
    assert tn == jn
    for key in tlc.MOE_EXPERT_KEYS:
        ja = jatt["blocks"]["g0"][f"moe/{key}"]["serve"]
        ta = tatt["blocks"]["g0"][f"moe/{key}"]["serve"]
        for f in ART_FIELDS:
            assert getattr(ta, f).shape[:2] == (tm.n_rep, e)
            np.testing.assert_array_equal(t2n(getattr(ta, f)),
                                          np.asarray(getattr(ja, f)))
