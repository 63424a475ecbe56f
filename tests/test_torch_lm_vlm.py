"""Port parity for the VLM prefix (internvl2-26b, reduced: 2 layers, d 128,
4 query heads over 2 KV heads, a prefix of 8 patch embeddings, float32
compute): `forward`, `prefill` and `decode_step` after a prefix, the k = 4
fake-quant forward, `loss` on the trailing token positions, one
`make_train_step` step and `make_prefill_step` with ``prefix_embeds``, JAX
package against `repro_torch` on the same numpy arrays; then the port's
export and served prefill after a prefix, and ``compress --target lm
--arch internvl2-26b`` through export and its serve stage.

Tolerances and why:
  * ``forward`` / ``prefill`` / ``decode_step`` under ``QuantConfig.off()``
    and the loss: rel 1e-5 (olmo-1b's bounds in `test_torch_lm_model.py`:
    the same float32 operations, only summation orders differ);
  * ``QuantConfig.on()`` logits: rel 1e-3 (the port's fake-quant products
    are correctly rounded, JAX's float32 sums: an activation within ~1e-7
    of an int8 rounding boundary may quantize one step apart);
  * the train step's gradients, read from its first Adam moment: rel-L2
    1e-4 a leaf, QAT off;
  * served (K2's plain version on the CPU) vs fake-quant prefill in the
    port: rel 1e-5 (`test_torch_lm_model.py`'s served-vs-fake-quant bound:
    the straight-through weight is the artifact's up to float32 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import lm_compress as jlc
from repro.launch import train as jtrain
from repro.models.lm import build_lm as jbuild
from repro.nn.layers import QuantConfig as JQ
from repro.nn.spec import flatten_with_names as jflat
from repro.nn.spec import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.core import lm_compress as tlc
from repro_torch.launch import train as ttrain
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn.layers import QuantConfig as TQ
from repro_torch.nn.spec import flatten_with_names as tflat
from repro_torch.nn.spec import params_from_numpy
from repro_torch.pipeline.plan import CompressionPlan as TPlan

ARCH = "internvl2-26b"
B, S, MAX_LEN, DECODE_STEPS, BLOCK = 2, 12, 32, 3, 16
TOL, ON_TOL, GRAD_TOL = 1e-5, 1e-3, 1e-4
LR = 1e-3


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


@pytest.fixture(scope="module")
def ref():
    """The reduced internvl2 in both packages, JAX's parameters and k = 4
    comp carried across, seeded numpy tokens and prefix embeddings, and the
    JAX reference outputs, computed once."""
    jcfg = jget(ARCH).scaled_down(compute_dtype="float32")
    tcfg = tget(ARCH).scaled_down(compute_dtype="float32")
    assert jcfg.prefix_len == tcfg.prefix_len == 8
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    jcomp = jlc.restrict_all_codebooks(jm, jlc.init_lm_comp(jm),
                                       jlc.symmetric_codebook_values(4))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    prefix = rng.standard_normal((B, jcfg.prefix_len, jcfg.d_model)
                                 ).astype(np.float32)
    nxt = rng.integers(0, jcfg.vocab, (DECODE_STEPS, B, 1)).astype(np.int32)
    out = dict(jcfg=jcfg, jm=jm, tm=tm, jp=jp, tp=j2t(jp), jcomp=jcomp,
               tcomp=j2t(jcomp), tokens=tokens, prefix=prefix, nxt=nxt)
    tok, pre = jnp.asarray(tokens[:, :-1]), jnp.asarray(prefix)
    kw = dict(q_block=BLOCK, kv_block=BLOCK)
    out["off"] = jax.jit(lambda p, t, e: jm.forward(
        p, t, prefix_embeds=e, **kw)[0])(jp, tok, pre)
    out["on"] = jax.jit(lambda p, t, e, c: jm.forward(
        p, t, prefix_embeds=e, qcfg=JQ.on(), comp=c, **kw)[0])(
            jp, tok, pre, jcomp)
    logits, cache = jm.prefill(jp, tok, MAX_LEN, prefix_embeds=pre,
                               cache_dtype=jnp.float32, **kw)
    out["prefill"], out["prefill_pos"] = logits, np.asarray(cache["pos"])
    steps = []
    for i in range(DECODE_STEPS):
        logits, cache = jm.decode_step(jp, cache, jnp.asarray(nxt[i]))
        steps.append(logits)
    out["decode"] = steps
    return out


def _batch(r, lib):
    tokens, prefix = r["tokens"], r["prefix"]
    arr = jnp.asarray if lib == "jax" else torch.as_tensor
    return {"tokens": arr(tokens[:, :-1]), "labels": arr(tokens[:, 1:]),
            "prefix_embeds": arr(prefix)}


# ------------------------------------------------------------ the model


def test_forward_with_prefix_matches_jax(ref):
    """The prefix goes in front of the tokens: logits over P + S
    positions, equal to JAX's."""
    r = ref
    with torch.no_grad():
        got, _ = r["tm"].forward(r["tp"], torch.as_tensor(r["tokens"][:, :-1]),
                                 prefix_embeds=torch.as_tensor(r["prefix"]),
                                 q_block=BLOCK, kv_block=BLOCK)
    assert tuple(got.shape) == (B, r["jcfg"].prefix_len + S,
                                r["jcfg"].padded_vocab)
    assert logit_rel(got, r["off"], r["jcfg"].vocab) < TOL


def test_prefix_changes_the_token_logits(ref):
    """The token positions' logits after a prefix differ from those of the
    tokens alone (the prefix is attended to, not dropped)."""
    r = ref
    tok = torch.as_tensor(r["tokens"][:, :-1])
    p = r["jcfg"].prefix_len
    with torch.no_grad():
        with_prefix, _ = r["tm"].forward(
            r["tp"], tok, prefix_embeds=torch.as_tensor(r["prefix"]))
        alone, _ = r["tm"].forward(r["tp"], tok)
    vocab = r["jcfg"].vocab
    assert alone.shape[1] == S
    assert rel(t2n(with_prefix[:, p:, :vocab]), t2n(alone[..., :vocab])) > 1e-2


def test_prefill_and_decode_with_prefix_match_jax(ref):
    """`prefill` after the prefix: logits over P + S positions and a cache
    at ``pos = P + S``; the decode steps that follow equal JAX's."""
    r = ref
    with torch.no_grad():
        logits, cache = r["tm"].prefill(
            r["tp"], torch.as_tensor(r["tokens"][:, :-1]), MAX_LEN,
            prefix_embeds=torch.as_tensor(r["prefix"]),
            cache_dtype=torch.float32, q_block=BLOCK, kv_block=BLOCK)
        assert logit_rel(logits, r["prefill"], r["jcfg"].vocab) < TOL
        np.testing.assert_array_equal(t2n(cache["pos"]), r["prefill_pos"])
        assert (r["prefill_pos"] == r["jcfg"].prefix_len + S).all()
        for i in range(DECODE_STEPS):
            logits, cache = r["tm"].decode_step(
                r["tp"], cache, torch.as_tensor(r["nxt"][i]))
            assert logit_rel(logits, r["decode"][i], r["jcfg"].vocab) < TOL


def test_fake_quant_forward_with_prefix_matches_jax(ref):
    """The k = 4 fake-quant forward after a prefix (the prefix rows take
    the same activation fake-quant as the token rows)."""
    r = ref
    with torch.no_grad():
        got, _ = r["tm"].forward(r["tp"], torch.as_tensor(r["tokens"][:, :-1]),
                                 prefix_embeds=torch.as_tensor(r["prefix"]),
                                 qcfg=TQ.on(), comp=r["tcomp"],
                                 q_block=BLOCK, kv_block=BLOCK)
    assert logit_rel(got, r["on"], r["jcfg"].vocab) < ON_TOL


# ------------------------------------------------------ loss and steps


@pytest.mark.parametrize("qat", [False, True])
def test_loss_scores_the_trailing_token_positions(ref, qat):
    """`loss` with a prefix equals JAX's, and is the mean negative
    log-likelihood of the labels at the last S positions only."""
    r = ref
    kw = dict(q_block=BLOCK, kv_block=BLOCK)
    jl, _ = r["jm"].loss(r["jp"], _batch(r, "jax"), qcfg=JQ(enabled=qat),
                         comp=r["jcomp"] if qat else None, **kw)
    with torch.no_grad():
        tl, tmet = r["tm"].loss(r["tp"], _batch(r, "torch"),
                                qcfg=TQ(enabled=qat),
                                comp=r["tcomp"] if qat else None, **kw)
        logits, _ = r["tm"].forward(
            r["tp"], torch.as_tensor(r["tokens"][:, :-1]),
            prefix_embeds=torch.as_tensor(r["prefix"]), qcfg=TQ(enabled=qat),
            comp=r["tcomp"] if qat else None, **kw)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    logp = torch.log_softmax(logits[:, -S:].double(), -1)
    labels = torch.as_tensor(r["tokens"][:, 1:]).long()
    nll = -torch.gather(logp, -1, labels[..., None]).mean()
    np.testing.assert_allclose(float(tmet["ce"]), float(nll), rtol=TOL)


def test_train_step_with_prefix_matches_jax(ref):
    """One QAT-off `make_train_step` step on a batch with
    ``prefix_embeds``: loss rel 1e-5, every gradient leaf rel-L2 1e-4."""
    r = ref
    jcfg = jtrain.StepConfig(qat=False, with_comp=True, remat=False,
                             q_block=BLOCK, kv_block=BLOCK, lr=LR)
    jstate = {"params": r["jp"], "opt": jtrain.make_optimizer(jcfg).init(
        r["jp"])}
    jstate, jmet = jax.jit(jtrain.make_train_step(r["jm"], jcfg))(
        jstate, _batch(r, "jax"), r["jcomp"])
    jstate = jax.device_get(jstate)
    tcfg = ttrain.StepConfig(qat=False, with_comp=True, remat=False,
                             q_block=BLOCK, kv_block=BLOCK, lr=LR)
    tstate = {"params": r["tp"], "opt": ttrain.make_optimizer(tcfg).init(
        r["tp"])}
    tstate, tmet = ttrain.make_train_step(r["tm"], tcfg)(
        tstate, _batch(r, "torch"), r["tcomp"])
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=TOL)
    jmu, tmu = jflat(jstate["opt"]["mu"]), tflat(tstate["opt"]["mu"])
    assert list(jmu) == list(tmu)
    for name in jmu:
        a, b = tmu[name].numpy().astype(np.float64), np.asarray(jmu[name])
        assert np.linalg.norm(a - b) <= GRAD_TOL * np.linalg.norm(b), name
    assert float(np.abs(np.asarray(jmu["embed/table"])).max()) > 0


def test_prefill_step_with_prefix_matches_jax(ref):
    r = ref
    jcfg = jtrain.StepConfig(q_block=BLOCK, kv_block=BLOCK)
    tcfg = ttrain.StepConfig(q_block=BLOCK, kv_block=BLOCK)
    jb, tb = _batch(r, "jax"), _batch(r, "torch")
    del jb["labels"], tb["labels"]
    want = jtrain.make_prefill_step(r["jm"], jcfg)(r["jp"], jb)
    got = ttrain.make_prefill_step(r["tm"], tcfg)(r["tp"], tb)
    assert logit_rel(got, want, r["jcfg"].vocab) < TOL
    assert logit_rel(got, r["off"], r["jcfg"].vocab) < TOL


# --------------------------------------------------- export and serving


def test_export_and_served_prefill_with_prefix(ref):
    """The k = 4 plan's export (7 matmuls a layer, LUT parity), then a
    served prefill after the prefix (K2's plain version on these CPU
    tensors) against the port's fake-quant forward."""
    r = ref
    tm, tp, tcomp = r["tm"], r["tp"], r["tcomp"]
    arts, skipped = tlc.export_lm_matmuls(tm, tp, tcomp)
    assert len(arts) == 7 * r["jcfg"].n_layers and not skipped
    assert max(tlc.lut_parity_report(tm, tp, tcomp, arts,
                                     check_units=len(arts)).values()) < 1e-5
    comp_serve, _ = tlc.attach_serve_artifacts(tm, tp, tcomp)
    tok = torch.as_tensor(r["tokens"][:, :-1])
    pre = torch.as_tensor(r["prefix"])
    with torch.no_grad():
        served, cache = tm.prefill(tp, tok, MAX_LEN, prefix_embeds=pre,
                                   qcfg=TQ.serve(), comp=comp_serve,
                                   cache_dtype=torch.float32)
        fake, _ = tm.forward(tp, tok, prefix_embeds=pre, qcfg=TQ.on(),
                             comp=tcomp)
    assert int(cache["pos"][0]) == r["jcfg"].prefix_len + S
    assert logit_rel(served, fake, r["jcfg"].vocab) < TOL


def test_compress_and_serve_cli_run_internvl2(ref, tmp_path, capsys):
    """``compress --target lm --arch internvl2-26b --reduced`` runs through
    export with the JAX package's unit count (7 stacked units, 14 exported
    matmuls), and the plan's serve stage
    serves text prompts (no prefix: the engine takes none, as in JAX)."""
    from repro_torch.pipeline import cli

    plan_base = str(tmp_path / "plan")
    assert cli.main(["compress", "--target", "lm", "--arch", ARCH,
                     "--reduced", "--device", "cpu", "--quiet",
                     "--plan-out", plan_base]) == 0
    plan = TPlan.load(plan_base)
    assert plan.completed[-1] == "export"
    assert plan.metrics["n_units"] == len(jlc.lm_comp_layers(ref["jm"])) \
        == 7
    assert plan.metrics["export_layers"] == 7 * ref["jcfg"].n_layers
    assert cli.main(["serve", "--plan-in", plan_base, "--device", "cpu",
                     "--verify-oneshot", "--quiet", "--plan-out",
                     str(tmp_path / "served")]) == 0
    m = TPlan.load(tmp_path / "served").metrics
    assert m["serve_parity_engine_vs_oneshot"] is True
    assert m["serve_recompiles_after_warmup"] == 0
    capsys.readouterr()
