"""QAT training in the port against the JAX package: the optimizer stack,
the train step of the runner (loss, gradients, AdamW), a few steps of
training, and the ``profile`` stage with QAT base training.

Both packages start from the JAX package's initial parameters and read the
same numpy batches.

Tolerances and why:
  * AdamW / SGD-momentum updates, parameters and states over 3 steps: every
    leaf rel-L2 1e-6 (float32, the same operations; the global norm sums in
    another order). Schedules: rtol 1e-6.
  * one train step, LeNet-5 and ResNet-8 at batch 8: loss rel 1e-5, every
    gradient leaf rel-L2 1e-4. The port's convolutions, batch norm and pools
    are correctly rounded (float64 sums), the JAX package's are float32
    sums, so the two differ by float32 round-off (measured <= 3.2e-6 per
    leaf). One case cannot meet this: ResNet-8 under ``QuantConfig.on()``,
    where that round-off moves one activation of ``s1b1/conv2``'s input
    across a `fake_quant_act` rounding boundary (one int8 step) and the
    later layers carry it on (11, 55, 400, 1306 flips by ``s3b1/conv2``).
    There the test checks that the int8 activations agree exactly up to the
    first flip, that the first flip is at most 2 elements (a rounding tie),
    and holds the loss at rel 3e-3 (measured 7.6e-4) and the gradients at
    whole-tree rel-L2 1e-1 (measured 6.5e-2: at batch 8 the 1306 flipped
    activations move the batch-norm gradients); ROADMAP.md queue 3.
  * parameters after 5 steps, whole-tree rel-L2: 1e-3 under
    ``QuantConfig.off()`` (measured 7e-7 LeNet-5, 2.5e-4 ResNet-8). Under
    ``.on()`` the two trajectories part: the round-off above flips a few
    weights' int8 values after the first step (13 on LeNet-5), AdamW turns
    each flipped gradient sign into a full ``lr`` step, and the flips
    compound (measured 5.6e-3 LeNet-5, 1.4e-2 ResNet-8; ROADMAP.md queue
    3). There the test holds each step taken from the JAX package's state
    (teacher forcing) at 1e-3 for LeNet-5 (measured 1.5e-4) and the
    free-running trajectories at 3e-2.
  * the ``profile`` stage after 2 QAT steps (LeNet-5, batch 2, every tile
    traced): histograms and counts exact, ``energy_sum`` rtol 2e-3 (the JAX
    oracle's own float32 drift, see test_torch_profile_stage.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.runner import CnnRunner as JRunner
from repro.core.runner import cross_entropy as j_cross_entropy
from repro.nn import cnn as jcnn
from repro.nn.layers import QuantConfig as JQ
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.pipeline.config import PipelineConfig as JConfig
from repro.pipeline.pipeline import Pipeline as JPipeline
from repro.pipeline.targets import CnnTarget as JTarget
from repro_torch.core.runner import CnnRunner as TRunner
from repro_torch.core.runner import cross_entropy as t_cross_entropy
from repro_torch.kernels.fake_quant import fake_quant as tkernel
from repro_torch.nn import cnn as tcnn
from repro_torch.nn import layers as tL
from repro_torch.nn.layers import QuantConfig as TQ
from repro_torch.nn.spec import params_from_numpy
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.pipeline.config import PipelineConfig as TConfig
from repro_torch.pipeline.pipeline import Pipeline as TPipeline
from repro_torch.pipeline.targets import CnnTarget as TTarget

_SPLIT = {"train": 0, "val": 1, "test": 2}
LR = 2e-3                       # TargetConfig.lr, what the pipeline trains at


def j2t(tree):
    return params_from_numpy(jax.device_get(tree), "cpu")


def flat(tree, prefix=""):
    """{path: float64 numpy array} of a nested dict of arrays/tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix: np.asarray(tree, np.float64)}


def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def tree_rel(port, ref):
    fp, fr = flat(port), flat(ref)
    assert set(fp) == set(fr)
    num = sum(np.sum((fp[k] - fr[k]) ** 2) for k in fr)
    return float(np.sqrt(num / sum(np.sum(fr[k] ** 2) for k in fr)))


class _NumpyImages:
    """Seeded numpy batches, handed to both packages' runners."""

    def arrays(self, step, batch_size, split):
        rng = np.random.default_rng([3, _SPLIT[split], step])
        x = rng.normal(size=(batch_size, 32, 32, 3)).astype(np.float32)
        return x, rng.integers(0, 10, batch_size)


class _JaxImages(_NumpyImages):
    def batch(self, step, batch_size, split="train"):
        x, y = self.arrays(step, batch_size, split)
        return jnp.asarray(x), jnp.asarray(y, jnp.int32)


class _TorchImages(_NumpyImages):
    def batch(self, step, batch_size, split="train", *, device):
        x, y = self.arrays(step, batch_size, split)
        return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


# ------------------------------------------------------------- optimizers


def _trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"conv": (3, 3, 4, 8), "bn": {"scale": (8,), "bias": (8,)},
              "fc": {"w": (16, 10), "b": (10,)}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (rng.normal(size=s) * 0.3).astype(np.float32)

    return make(shapes)


def _leaves_close(port, ref, tol=1e-6):
    """Every leaf within rel-L2 ``tol`` (elementwise, ``mu`` cancels to
    ~1e-9 in places, where float32 round-off of the clip scale is a large
    relative error)."""
    fp = flat(port)
    for k, v in flat(ref).items():
        assert rel(fp[k], v) <= tol, (k, rel(fp[k], v))


def _run_optimizer(j_opt, t_opt, steps=3):
    params = _trees(0)
    jp, tp = jax.tree.map(jnp.asarray, params), j2t(params)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for i in range(steps):
        g = _trees(100 + i)
        ju, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = t_opt.update(j2t(g), ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        _leaves_close(tu, ju)
    _leaves_close(tp, jp)
    _leaves_close(ts, js)
    assert int(ts["step"]) == steps and ts["step"].dtype == torch.int32


@pytest.mark.parametrize("max_grad_norm", [1.0, None])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_jax(max_grad_norm, weight_decay):
    kw = dict(weight_decay=weight_decay, max_grad_norm=max_grad_norm)
    _run_optimizer(jopt.adamw(LR, **kw), topt.adamw(LR, **kw))


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgdm_matches_jax(nesterov):
    kw = dict(nesterov=nesterov, weight_decay=1e-3, max_grad_norm=0.5)
    _run_optimizer(jopt.sgdm(0.05, **kw), topt.sgdm(0.05, **kw))


def test_global_norm_and_clip_match_jax():
    g = _trees(5)
    jn = jopt.global_norm(jax.tree.map(jnp.asarray, g))
    np.testing.assert_allclose(float(topt.global_norm(j2t(g))), float(jn),
                               rtol=1e-6)
    jc, _ = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.1)
    tc, _ = topt.clip_by_global_norm(j2t(g), 0.1)
    _leaves_close(tc, jc)


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-3,)),
    ("warmup_cosine", (1e-2, 5, 40, 0.1)),
    ("linear_decay", (1e-2, 30, 0.05)),
])
def test_schedules_match_jax(name, args):
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(16, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 16)
    want = float(j_cross_entropy(jnp.asarray(logits),
                                 jnp.asarray(labels, jnp.int32)))
    got = float(t_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------ train step


def _runners(arch, quant, batch=8):
    jr = JRunner(getattr(jcnn, arch)(), _JaxImages(), batch_size=batch,
                 lr=LR, qcfg=getattr(JQ, quant)())
    tr = TRunner(getattr(tcnn, arch)(), _TorchImages(), batch_size=batch,
                 lr=LR, qcfg=getattr(TQ, quant)(), device="cpu")
    start = jr.init()
    return jr, tr, start


def _first_flip(jr, tr, start, x):
    """(layer, number of differing int8 inputs) of the first compressible
    layer whose train-mode fake-quantized input differs between the
    packages, or (None, 0)."""
    p, s, _, c = start
    jt = jax.jit(lambda p, s, c, x: jr.model.apply(
        p, s, x, train=True, qcfg=jr.qcfg, comp=c, capture_taps=True)[2])(
            p, s, c, jnp.asarray(x))
    tp, ts, _, tc = (j2t(t) for t in start)
    with torch.no_grad():
        _, _, tt = tr.model.apply(tp, ts, torch.from_numpy(x), train=True,
                                  qcfg=tr.qcfg, comp=tc, capture_taps=True)
    for cl in jr.model.comp_layers:
        diff = int((np.asarray(jt[cl.name]["a_int"])
                    != tt[cl.name]["a_int"].numpy()).sum())
        if diff:
            return cl.name, diff
    return None, 0


@pytest.mark.parametrize("quant", ["off", "on"])
@pytest.mark.parametrize("arch", ["lenet5", "resnet8"])
def test_train_step_matches_jax(arch, quant):
    jr, tr, start = _runners(arch, quant)
    p, s, _, c = start
    x, y = _JaxImages().batch(0, 8)

    def loss_fn(params):
        logits, _, _ = jr.model.apply(params, s, x, train=True, qcfg=jr.qcfg,
                                      comp=c)
        return j_cross_entropy(logits, y)

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(p)
    tp, ts, _, tc = (j2t(t) for t in start)
    before = tkernel.launches
    t_loss, t_grads, t_state = tr.loss_and_grads(
        tp, ts, tc, _TorchImages().batch(0, 8, device="cpu"))
    assert tkernel.launches == before            # CPU tensors: plain K3
    assert all(not v.requires_grad for v in flat_tensors(t_state))
    loss_rel = abs(float(t_loss) - float(j_loss)) / abs(float(j_loss))
    fj, ft = flat(j_grads), flat(t_grads)
    assert set(ft) == set(fj)

    if quant == "on":
        layer, flips = _first_flip(jr, tr, start, np.asarray(x))
    if (arch, quant) == ("resnet8", "on"):
        # one activation crosses an int8 rounding boundary (module doc)
        assert layer == "s1b1/conv2" and flips <= 2, (layer, flips)
        assert loss_rel <= 3e-3, loss_rel
        assert tree_rel(t_grads, j_grads) <= 1e-1
        return
    if quant == "on":
        assert layer is None, (layer, flips)
    assert loss_rel <= 1e-5, loss_rel
    for k, v in fj.items():
        assert rel(ft[k], v) <= 1e-4, (k, rel(ft[k], v))


def flat_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in flat_tensors(v)]
    return [tree]


@pytest.mark.parametrize("quant", ["off", "on"])
@pytest.mark.parametrize("arch", ["lenet5", "resnet8"])
def test_five_train_steps_track_jax(arch, quant):
    jr, tr, start = _runners(arch, quant)
    jp, js, jo, jc = start
    tp, ts, to, tc = (j2t(t) for t in start)
    forced = []
    for step in range(5):
        # the port's step from the JAX package's state (teacher forcing)
        fp, _, _, _ = tr.train(*(j2t(t) for t in (jp, js, jo)), tc, 1,
                               start_step=step)
        jp, js, jo, j_loss = jr.train(jp, js, jo, jc, 1, start_step=step)
        tp, ts, to, t_loss = tr.train(tp, ts, to, tc, 1, start_step=step)
        forced.append(tree_rel(fp, jp))
    assert int(to["step"]) == 5
    free = tree_rel(tp, jp)
    if quant == "off":
        assert free <= 1e-3, free
        assert max(forced) <= 1e-3, forced
        return
    # QuantConfig.on(): int8 flips compound (module doc, ROADMAP.md queue 3)
    assert free <= 3e-2, free
    if arch == "lenet5":
        assert max(forced) <= 1e-3, forced


def test_train_returns_nan_loss_for_no_steps():
    _, tr, start = _runners("lenet5", "on")
    tp, ts, to, tc = (j2t(t) for t in start)
    out = tr.train(tp, ts, to, tc, 0)
    assert np.isnan(out[3]) and out[0] is tp and int(out[2]["step"]) == 0


def test_batchnorm_running_state_is_detached():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 5, 5, 3)).astype(np.float32))
    params = {"scale": torch.ones(3, requires_grad=True),
              "bias": torch.zeros(3, requires_grad=True)}
    state = {"mean": torch.zeros(3), "var": torch.ones(3)}
    y, new = tL.apply_batchnorm(params, state, x.requires_grad_(True),
                                train=True)
    assert y.requires_grad and y.dtype == torch.float32
    assert not new["mean"].requires_grad and not new["var"].requires_grad
    assert new["mean"].dtype == torch.float32


# ------------------------------------------------------- profile with QAT


def test_profile_stage_with_qat_matches_jax():
    cfg = {"target": {"arch": "lenet5", "batch_size": 2},
           "train": {"qat_steps": 2, "eval_batches": 2},
           "profile": {"batches": 1, "max_tiles": 64}}
    jcfg = JConfig.from_dict(cfg)
    jr = JRunner(jcnn.lenet5(), _JaxImages(), batch_size=2, seed=0,
                 lr=jcfg.target.lr)
    start = jr.init()
    jplan = JPipeline(JTarget(jcfg, runner=jr), jcfg).run_until("profile")

    tcfg = TConfig.from_dict(cfg)
    tr = TRunner(tcnn.lenet5(), _TorchImages(), batch_size=2, seed=0,
                 lr=tcfg.target.lr, device="cpu")
    carried = tuple(j2t(t) for t in start)
    tr.init = lambda: carried
    pipe = TPipeline(tcfg, device="cpu")
    pipe.target = TTarget(tcfg, torch.device("cpu"), runner=tr)
    tplan = pipe.run_until("profile")

    assert tplan.completed == ("profile",)
    np.testing.assert_allclose(tplan.metrics["qat_loss"],
                               jplan.metrics["qat_loss"], rtol=1e-5)
    assert tplan.metrics["acc_base"] == jplan.metrics["acc_base"]
    assert tree_rel(tplan.params, jplan.params) <= 1e-3
    assert int(tplan.opt_state["step"]) == 2
    for name, js in jplan.stats.items():
        ts = tplan.stats[name]
        assert ts.n_transitions == js.n_transitions
        for f in ("count", "group_hist", "act_hist"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f"{name}.{f}")
        np.testing.assert_allclose(ts.energy_sum.numpy(),
                                   np.asarray(js.energy_sum), rtol=2e-3,
                                   err_msg=name)
