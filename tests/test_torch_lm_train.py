"""Port parity for LM QAT (reduced olmo-1b: 2 layers, d 128, GQA, float32
compute): `SyntheticTokens`, `LMModel.loss`, one `make_train_step` step
against the JAX package's on the same params, comp and numpy batch,
gradient accumulation, remat, the LM target's QAT stage and the
``repro_torch.launch.train`` CLI.

Tolerances and why (measured gaps on this host in parentheses):
  * the loss, QAT off and on: rel 1e-5 (0: at this size the same float32
    logits come out of both forwards);
  * gradients, read from the step's first Adam moment (``mu = 0.1 * g``
    after the global-norm clip, which both packages take from the same
    gradients): rel-L2 a leaf 1e-5 with QAT off (9.9e-7: float32
    summation orders, a 10x margin), 1e-4 with QAT on (9.0e-7). With QAT
    the port's products are correctly rounded and JAX's are float32 sums,
    so an activation within ~1e-7 of an int8 rounding boundary could
    quantize one step apart; at these inputs none does, and the bound
    leaves a 100x margin for such a flip. (The port's products' backward
    sums in float64, JAX's in float32.) `exact_matmul`'s backward equals
    autograd through the float64 product bit for bit;
  * updated params: abs 2e-4 (9.2e-5). The first AdamW step moves a
    weight by about ``lr * sign(g)``, so a gradient entry near 0 whose
    float32 value differs in its last bits moves its weight by up to
    ``lr`` = 1e-3 either way; none does at these inputs;
  * ``grad_accum=2`` against one full batch, QAT off: rel 1e-5 (two
    float32 means of halves against one mean);
  * ``remat=True`` against ``remat=False``: equal, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import lm_compress as jlc
from repro.core import qat as jqat
from repro.data.synthetic import SyntheticTokens as JTokens
from repro.launch import train as jtrain
from repro.models.lm import build_lm as jbuild
from repro.nn.layers import QuantConfig as JQ
from repro.nn.spec import flatten_with_names as jflat
from repro.nn.spec import init_params as jinit
from repro.pipeline.plan import CompressionPlan as JPlan
from repro_torch.configs import get_config as tget
from repro_torch.core import qat as tqat
from repro_torch.data.synthetic import SyntheticTokens as TTokens
from repro_torch.kernels.lut_matmul import ref as k2ref
from repro_torch.launch import train as ttrain
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn.layers import QuantConfig as TQ
from repro_torch.nn.spec import flatten_with_names as tflat
from repro_torch.nn.spec import params_from_numpy
from repro_torch.pipeline.config import reduced_lm_config as t_reduced_lm
from repro_torch.pipeline.pipeline import Pipeline as TPipeline

LR = 1e-3
B, S, BLOCK = 4, 32, 16


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
    """(JAX model, port model, JAX params, port params, JAX k = 8 comp,
    port comp, numpy (tokens, labels))."""
    jm = jbuild(jget("olmo-1b").scaled_down(compute_dtype="float32"))
    tm = tbuild(tget("olmo-1b").scaled_down(compute_dtype="float32"))
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    jc = jlc.restrict_all_codebooks(jm, jlc.init_lm_comp(jm),
                                    jlc.symmetric_codebook_values(8))
    toks = np.random.default_rng(0).integers(
        0, jm.cfg.vocab, (B, S + 1)).astype(np.int32)
    return (jm, tm, jp, params_from_numpy(jax.device_get(jp), "cpu"), jc,
            params_from_numpy(jax.device_get(jc), "cpu"),
            (toks[:, :-1], toks[:, 1:]))


def jbatch(batch):
    return {"tokens": jnp.asarray(batch[0]), "labels": jnp.asarray(batch[1])}


def tbatch(batch):
    return {"tokens": torch.as_tensor(batch[0]),
            "labels": torch.as_tensor(batch[1])}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("vocab,seed", [(50304, 7), (151936, 3), (300, 0)])
def test_synthetic_tokens_follow_the_jax_process(vocab, seed):
    t, j = TTokens(vocab=vocab, seed=seed), JTokens(vocab=vocab, seed=seed)
    assert (t._a, t._b) == (j._a, j._b)
    x, y = t.batch(3, 16, 64, device="cpu")
    assert x.shape == y.shape == (16, 64)
    assert x.dtype == y.dtype == torch.int32
    assert torch.equal(x[:, 1:], y[:, :-1])
    assert int(x.min()) >= 0 and int(y.max()) < vocab
    # the bigram map holds where no noise was drawn (about 1 - eps)
    hit = float((t.next_tokens(x) == y).float().mean())
    assert abs(hit - (1 - t.eps)) < 0.05
    # the map is the JAX package's int32 arithmetic, wrap-around included
    cur = np.random.default_rng(seed).integers(0, vocab, 256).astype(
        np.int32)
    want = (jnp.asarray(cur) * j._a + j._b) % vocab
    np.testing.assert_array_equal(
        t.next_tokens(torch.as_tensor(cur)).numpy(), np.asarray(want))
    # seeded: a pure function of (seed, split, step)
    assert torch.equal(x, t.batch(3, 16, 64, device="cpu")[0])
    assert not torch.equal(x, t.batch(4, 16, 64, device="cpu")[0])
    assert not torch.equal(x, t.batch(3, 16, 64, "val", device="cpu")[0])


def test_apply_comp_dtype_matches_jax(lm):
    _, _, _, _, jc, tc, _ = lm
    jcu = jc["blocks"]["g0"]["attn/wq"]
    tcu = tc["blocks"]["g0"]["attn/wq"]
    out_j = jqat.apply_comp_dtype(jcu, jnp.float32)
    out_t = tqat.apply_comp_dtype(tcu, torch.float32)
    assert out_t["mask"].dtype == torch.float32
    np.testing.assert_array_equal(out_t["mask"].numpy(),
                                  np.asarray(out_j["mask"]))
    assert out_t["codebook"] is tcu["codebook"]


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("qat", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_jax(lm, qat, masked):
    jm, tm, jp, tp, jc, tc, batch = lm
    jb, tb = jbatch(batch), tbatch(batch)
    if masked:
        mask = (np.arange(S)[None, :] % 3 != 0).astype(np.float32)
        mask = np.broadcast_to(mask, (B, S)).copy()
        jb["loss_mask"], tb["loss_mask"] = jnp.asarray(mask), \
            torch.as_tensor(mask)
    kw = dict(q_block=BLOCK, kv_block=BLOCK)
    jl, jmet = jm.loss(jp, jb, qcfg=JQ(enabled=qat), comp=jc if qat else None,
                       **kw)
    with torch.no_grad():
        tl, tmet = tm.loss(tp, tb, qcfg=TQ(enabled=qat),
                           comp=tc if qat else None, **kw)
    assert set(tmet) == {"ce", "lb_loss", "z_loss"}
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in tmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5)


# ------------------------------------------------------------- train step


def _tstep(lm, qat, **extra):
    """One step of the port's `make_train_step`: (state, metrics)."""
    _, tm, _, tp, _, tc, batch = lm
    cfg = ttrain.StepConfig(qat=qat, with_comp=True, remat=False,
                            q_block=BLOCK, kv_block=BLOCK, lr=LR, **extra)
    state = {"params": tp, "opt": ttrain.make_optimizer(cfg).init(tp)}
    return ttrain.make_train_step(tm, cfg)(state, tbatch(batch), tc)


def _jstep(lm, qat):
    """One step of the JAX package's `make_train_step` from the same
    state: (state on the host, metrics)."""
    jm, _, jp, _, jc, _, batch = lm
    cfg = jtrain.StepConfig(qat=qat, with_comp=True, remat=False,
                            q_block=BLOCK, kv_block=BLOCK, lr=LR)
    state = {"params": jp, "opt": jtrain.make_optimizer(cfg).init(jp)}
    state, met = jax.jit(jtrain.make_train_step(jm, cfg))(
        state, jbatch(batch), jc)
    return jax.device_get(state), met


@pytest.mark.parametrize("qat,grad_tol", [(False, 1e-5), (True, 1e-4)])
def test_train_step_matches_jax(lm, qat, grad_tol):
    jstate, jmet = _jstep(lm, qat)
    tstate, tmet = _tstep(lm, qat)
    assert set(tmet) == set(jmet)
    for k in tmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5)
    jmu, tmu = jflat(jstate["opt"]["mu"]), tflat(tstate["opt"]["mu"])
    assert list(jmu) == list(tmu)
    for name in jmu:
        assert rel_l2(tmu[name].numpy(), jmu[name]) < grad_tol, name
    jpar, tpar = jflat(jstate["params"]), tflat(tstate["params"])
    for name in jpar:
        np.testing.assert_allclose(tpar[name].numpy(), np.asarray(jpar[name]),
                                   rtol=0, atol=2e-4, err_msg=name)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 1


@pytest.mark.parametrize("shapes,dtype", [
    (((6, 5), (5, 7)), torch.float32),
    (((2, 3, 6), (6, 4)), torch.float32),
    (((3, 4, 6), (3, 6, 5)), torch.float32),
    (((2, 3, 1, 4, 8), (2, 3, 1, 8, 5)), torch.float32),
    (((2, 1, 4, 8), (2, 3, 8, 5)), torch.float32),
    (((2, 3, 6), (6, 4)), torch.bfloat16),
])
def test_exact_matmul_backward_is_autograd_through_float64(shapes, dtype):
    """`exact_matmul`'s backward equals autograd through the float64
    product bit for bit (broadcast operands included), and keeps no float64
    tensor for it."""
    g = torch.Generator().manual_seed(sum(map(sum, shapes)))
    a0, b0 = (torch.randn(s, generator=g).to(dtype) for s in shapes)
    w = torch.randn(torch.matmul(a0, b0).shape, generator=g)
    outs = []
    for fn in (k2ref.exact_matmul,
               lambda a, b: (a.double() @ b.double()).float()):
        a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.dtype) or t, lambda t: t):
            y = fn(a, b)
        (y * w).sum().backward()
        outs.append((y.detach(), a.grad, b.grad, saved))
    (y, ga, gb, saved), (y_ref, ga_ref, gb_ref, _) = outs
    assert torch.equal(y, y_ref)
    assert torch.equal(ga, ga_ref) and torch.equal(gb, gb_ref)
    assert ga.dtype == gb.dtype == dtype
    assert torch.float64 not in saved and saved


def test_grad_accum_matches_one_batch(lm):
    """Without QAT two micro-batches give the full batch's step up to
    float32 rounding. (With QAT they need not: an activation's int8 scale
    is one a call, the amax over the micro-batch, in both packages.)"""
    _, tm, _, tp, _, tc, batch = lm
    outs = []
    for n in (1, 2):
        cfg = ttrain.StepConfig(qat=False, remat=False, q_block=BLOCK,
                                kv_block=BLOCK, lr=LR, grad_accum=n)
        state = {"params": tp, "opt": ttrain.make_optimizer(cfg).init(tp)}
        outs.append(ttrain.make_train_step(tm, cfg)(state, tbatch(batch),
                                                    tc))
    (s1, m1), (s2, m2) = outs
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    mu1, mu2 = tflat(s1["opt"]["mu"]), tflat(s2["opt"]["mu"])
    for name in mu1:
        assert rel_l2(mu2[name].numpy(), mu1[name].numpy()) < 1e-5, name


@pytest.mark.parametrize("flash", [False, True])
def test_remat_gradients_equal_bit_for_bit(lm, flash):
    _, tm, _, tp, _, tc, batch = lm
    outs = []
    for remat in (False, True):
        cfg = ttrain.StepConfig(qat=True, remat=remat, q_block=BLOCK,
                                kv_block=BLOCK, lr=LR, flash=flash)
        state = {"params": tp, "opt": ttrain.make_optimizer(cfg).init(tp)}
        outs.append(ttrain.make_train_step(tm, cfg)(state, tbatch(batch),
                                                    tc))
    (s0, m0), (s1, m1) = outs
    assert torch.equal(m0["loss"], m1["loss"])
    f0, f1 = tflat(s0), tflat(s1)
    for name in f0:
        assert torch.equal(f0[name], f1[name]), name


def test_one_by_one_mesh_steps_equal_the_unmeshed(lm):
    """The mesh arguments and helpers build: abstract states on meta,
    shardings on a 1 x 1 abstract mesh, and the steps on it are the
    unmeshed ones bit for bit (nothing gathered or reduced: the mesh is
    this one process)."""
    from repro_torch.distributed import sharding as tsh

    _, tm, _, tp, _, tc, batch = lm
    mesh = tsh.AbstractMesh((1, 1), ("data", "model"))
    cfg = ttrain.StepConfig(qat=True, remat=True, q_block=BLOCK,
                            kv_block=BLOCK, lr=LR)
    for fn in (ttrain.abstract_train_state, ttrain.abstract_serve_params,
               ttrain.comp_abstract):
        tree = fn(tm)
        assert all(t.device.type == "meta" for t in tflat(tree).values())
    specs = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                   device="meta")}
    for tree, sh in ((specs, ttrain.batch_shardings(specs, mesh)),
                     (ttrain.abstract_train_state(tm),
                      ttrain.train_state_shardings(tm, mesh)),
                     (ttrain.comp_abstract(tm),
                      ttrain.comp_shardings(tm, mesh))):
        shards = tflat(sh)
        for name, t in tflat(tree).items():   # one position holds it all
            assert shards[name].shard_shape(t.shape) == tuple(t.shape)
    hook = ttrain.moe_dispatch_constraint(mesh, tsh.DEFAULT_RULES)
    x = torch.ones(2, 4, 8, 16)
    assert hook(x, "scatter") is x and hook(x, "expert") is x

    state = {"params": tp, "opt": ttrain.make_optimizer(cfg).init(tp)}
    want, wmet = ttrain.make_train_step(tm, cfg)(state, tbatch(batch), tc)
    got, gmet = ttrain.make_train_step(tm, cfg, mesh=mesh,
                                       rules=tsh.DEFAULT_RULES,
                                       moe_local_dispatch=True)(
        state, tbatch(batch), tc)
    assert all(torch.equal(gmet[k], wmet[k]) for k in wmet)
    fw, fg = tflat(want), tflat(got)
    assert all(torch.equal(fg[n], fw[n]) for n in fw)
    toks = tbatch(batch)["tokens"]
    prefill = ttrain.make_prefill_step(tm, cfg, mesh=mesh)(tp,
                                                           {"tokens": toks})
    assert torch.equal(prefill, ttrain.make_prefill_step(tm, cfg)(
        tp, {"tokens": toks}))


# ------------------------------------------------------------ the target


class _Batches:
    """Injected token batches: step i's numpy batch."""

    def __init__(self, batches):
        self.batches = batches

    def batch(self, step, batch_size, seq_len, *, device):
        x, y = self.batches[step]
        assert x.shape == (batch_size, seq_len)
        return (torch.as_tensor(x, device=device),
                torch.as_tensor(y, device=device))


def test_lm_target_qat_with_injected_batches(lm):
    """``train.qat_steps=2`` runs the JAX stage's step settings on the
    injected batches: the params equal two `make_train_step` steps by hand,
    bit for bit, and the stage keeps each step's loss and time."""
    _, tm, *_ = lm
    rng = np.random.default_rng(5)
    toks = [rng.integers(0, tm.cfg.vocab, (2, 65)).astype(np.int32)
            for _ in range(2)]
    batches = [(t[:, :-1], t[:, 1:]) for t in toks]
    cfg = t_reduced_lm("olmo-1b").with_overrides(
        {"train": {"qat_steps": 2}, "target": {"batch_size": 2}})
    pipe = TPipeline(cfg, device="cpu")
    pipe.target.data = _Batches(batches)
    plan = pipe.run_until("profile")

    init = TPipeline(t_reduced_lm("olmo-1b"), device="cpu").run_until(
        "profile")
    step_cfg = ttrain.StepConfig(qat=True, with_comp=True, remat=False,
                                 q_block=128, kv_block=128, lr=cfg.target.lr)
    step = ttrain.make_train_step(tm, step_cfg)
    state = {"params": init.params,
             "opt": ttrain.make_optimizer(step_cfg).init(init.params)}
    losses = []
    for x, y in batches:
        state, met = step(state, tbatch((x, y)), init.comp)
        losses.append(float(met["loss"]))
    got, want = tflat(plan.params), tflat(state["params"])
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert pipe.target.last_qat["loss"] == losses
    assert len(pipe.target.last_qat["step_s"]) == 2


def test_launch_train_cli_plan_loads_in_jax(tmp_path, capsys):
    base = tmp_path / "olmo"
    assert ttrain.main(["--reduced", "--steps", "2", "--batch-size", "2",
                        "--plan-out", str(base), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "LM QAT: 2 steps, final loss=" in out
    jplan = JPlan.load(base)
    assert tuple(jplan.completed) == ("profile", "energy_model")
    assert jplan.config["train"]["qat_steps"] == 2
    assert jplan.metrics["energy_per_token"] > 0
    init = TPipeline(t_reduced_lm("olmo-1b"), device="cpu").run_until(
        "profile").params
    got, before = jflat(jplan.params), tflat(init)
    assert list(got) == list(before)
    assert any(not np.array_equal(np.asarray(got[k]), before[k].numpy())
               for k in got)
