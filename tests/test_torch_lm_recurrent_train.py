"""Port parity for the recurrent families' QAT train step (reduced
mamba2-1.3b and recurrentgemma-2b, float32 compute): one
`make_train_step` step against the JAX package's on the same params, k = 8
comp and numpy batch, QAT off and on, as `test_torch_lm_train.py` holds
olmo-1b's. The backward runs through the SSD's batched products
(`nn/ssm.py`), `rglru.linear_scan`'s odd/even recursion and the mixers'
fake-quant projections.

Tolerances and why:
  * QAT off: olmo-1b's bounds, loss rel 1e-5, every gradient leaf rel-L2
    1e-5, updated params abs 2e-4 (measured 7.7e-8 / 3.4e-6 / 2.1e-5 for
    mamba2, 7.6e-8 / 2.0e-6 / 3.9e-5 for recurrentgemma);
  * QAT on, each package with its own int8 activation rounding: not
    comparable at those bounds. The port's products are correctly rounded
    and JAX's are float32 sums, so an activation within an ulp of a
    rounding boundary takes the next code in one of them; one flipped code
    moved a gradient leaf by up to 6.7e-3 rel-L2 and an updated weight by
    ``2 * lr`` (the first AdamW step moves a weight by about
    ``lr * sign(g)``). So the step is compared on shared rounding
    decisions: JAX's int8 codes, recorded inside its jitted step, are
    replayed into the port's step (chip_smoke's ``_ActQuant`` between the
    card and the CPU does the same). Then olmo-1b's QAT-on bounds hold:
    loss rel 1e-5, gradient rel-L2 1e-4, params abs 2e-4 (measured 0 /
    8.0e-6 / 3.6e-5 for mamba2, 7.6e-8 / 1.2e-6 / 1.1e-5 for
    recurrentgemma). One code of 65,536 (mamba2, 4 calls) and one of
    393,216 (recurrentgemma, 28 calls) differ between the two packages'
    own rounding: the gap was that flip, not a fault of the backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import lm_compress as jlc
from repro.core import qat as jqat
from repro.launch import train as jtrain
from repro.models.lm import build_lm as jbuild
from repro.nn.spec import flatten_with_names as jflat
from repro.nn.spec import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.core import qat as tqat
from repro_torch.launch import train as ttrain
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn.spec import flatten_with_names as tflat
from repro_torch.nn.spec import params_from_numpy

LR = 1e-3
B, S, BLOCK = 4, 32, 16
ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")
# the most activation codes the two packages' own rounding may disagree on
# (measured: 1 for each family)
MAX_FLIPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work in this file runs on one thread: beside the
    suite's parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """(arch, JAX model, port model, JAX params, port params, JAX comp,
    port comp, numpy (tokens, labels))."""
    arch = request.param
    jm = jbuild(jget(arch).scaled_down(compute_dtype="float32"))
    tm = tbuild(tget(arch).scaled_down(compute_dtype="float32"))
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    jc = jlc.restrict_all_codebooks(jm, jlc.init_lm_comp(jm),
                                    jlc.symmetric_codebook_values(8))
    toks = np.random.default_rng(0).integers(
        0, jm.cfg.vocab, (B, S + 1)).astype(np.int32)
    return (arch, jm, tm, jp, params_from_numpy(jax.device_get(jp), "cpu"),
            jc, params_from_numpy(jax.device_get(jc), "cpu"),
            (toks[:, :-1], toks[:, 1:]))


def _jstep(fam, qat, record=None):
    """The JAX package's step; ``record`` (a list) collects the int8 codes
    of every activation fake-quant call in execution order (an ordered
    host callback inside the jitted step)."""
    _, jm, _, jp, _, jc, _, (x, y) = fam
    real = jqat.fake_quant_act

    def recording(a):
        scale = jnp.maximum(jnp.max(jnp.abs(a)), 1e-8) / jqat.QMAX
        codes = jnp.clip(jnp.round(a / scale), -jqat.QMAX, jqat.QMAX)
        jax.debug.callback(lambda c: record.append(np.asarray(c)), codes,
                           ordered=True)
        return real(a)

    cfg = jtrain.StepConfig(qat=qat, with_comp=True, remat=False,
                            q_block=BLOCK, kv_block=BLOCK, lr=LR)
    state = {"params": jp, "opt": jtrain.make_optimizer(cfg).init(jp)}
    if record is not None:
        jqat.fake_quant_act = recording
    try:
        state, met = jax.jit(jtrain.make_train_step(jm, cfg))(
            state, {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}, jc)
        jax.effects_barrier()
    finally:
        jqat.fake_quant_act = real
    return jax.device_get(state), met


def _tstep(fam, qat, replay=None):
    """The port's step; ``replay`` (JAX's recorded codes) takes the place
    of the port's own rounding call by call. Returns (state, metrics,
    calls, codes that differ from the port's own rounding)."""
    _, _, tm, _, tp, _, tc, (x, y) = fam
    real = tqat.fake_quant_act
    seen = {"calls": 0, "flips": 0}

    def replaying(a, cand_dim=None, *, token_dims=0):
        scale = tqat._act_scale(a, cand_dim, token_dims)
        own = tqat._round_clip(a / scale)
        want = torch.from_numpy(np.array(replay[seen["calls"]]))
        want = want.to(own.dtype)
        assert want.shape == own.shape, (seen["calls"], want.shape)
        seen["calls"] += 1
        seen["flips"] += int((own != want).sum())
        return a + (want * scale - a).detach()

    cfg = ttrain.StepConfig(qat=qat, with_comp=True, remat=False,
                            q_block=BLOCK, kv_block=BLOCK, lr=LR)
    state = {"params": tp, "opt": ttrain.make_optimizer(cfg).init(tp)}
    if replay is not None:
        tqat.fake_quant_act = replaying
    try:
        state, met = ttrain.make_train_step(tm, cfg)(
            state, {"tokens": torch.as_tensor(x),
                    "labels": torch.as_tensor(y)}, tc)
    finally:
        tqat.fake_quant_act = real
    return state, met, seen["calls"], seen["flips"]


def _hold(jstate, jmet, tstate, tmet, grad_tol):
    assert set(tmet) == set(jmet)
    for k in tmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    jmu, tmu = jflat(jstate["opt"]["mu"]), tflat(tstate["opt"]["mu"])
    assert list(jmu) == list(tmu)
    for name in jmu:
        assert rel_l2(tmu[name].numpy(), jmu[name]) < grad_tol, name
    jpar, tpar = jflat(jstate["params"]), tflat(tstate["params"])
    for name in jpar:
        np.testing.assert_allclose(tpar[name].numpy(), np.asarray(jpar[name]),
                                   rtol=0, atol=2e-4, err_msg=name)


def test_recurrent_train_step_matches_jax_without_qat(fam):
    jstate, jmet = _jstep(fam, qat=False)
    tstate, tmet, _, _ = _tstep(fam, qat=False)
    _hold(jstate, jmet, tstate, tmet, grad_tol=1e-5)


def test_recurrent_qat_step_matches_jax_on_its_rounding(fam):
    record = []
    jstate, jmet = _jstep(fam, qat=True, record=record)
    n_layers = fam[2].cfg.n_layers
    # two quantized activations a layer (mamba2's in_proj and out_proj
    # inputs); recurrentgemma's attention and RG-LRU blocks take more
    assert len(record) >= 2 * n_layers
    tstate, tmet, calls, flips = _tstep(fam, qat=True, replay=record)
    assert calls == len(record)
    assert flips <= MAX_FLIPS, flips
    _hold(jstate, jmet, tstate, tmet, grad_tol=1e-4)
