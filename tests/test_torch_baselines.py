"""The paper's baselines in the port against the JAX package: the
PowerPruning-style global selection, naive top-k and Table 3's global
strategy on LeNet-5, and the two profile diagnostics
(`mac_model.weight_static_energy_profile`, `grouping.stability_ratio`).

Both runners read the same numpy batches (`test_torch_schedule.py`'s
`_NumpyImages` stream) and start from the same JAX-initialized,
JAX-pretrained params, state, AdamW state and comp. The per-layer LUTs are
the JAX package's uniform-trace LUT (drawn with `jax.random`, which the
port cannot replay) scaled by a seeded per-layer profile, handed to both
packages' `energy_models` in place of profiled statistics; the weight
histograms are each package's own.

Tolerances and why:
  * codebooks, masks, pruning ratios and accuracies: exact (the same
    host-side float64 ranking and greedy elimination on the same arrays,
    and the same int8 decisions through a few QAT steps);
  * ``energy_before``: rel 1e-5 (float32 histograms and LUT sums);
  * ``energy_after``, after fine-tuning: rel 1e-4, the schedule test's
    bound after fine-tuning: float32 round-off of the JAX package's
    convolutions can flip an int8 weight that AdamW then moves a full step
    (ROADMAP.md queue 3);
  * `weight_static_energy_profile` on JAX's injected sequences: rel 1e-6
    (a float32 mean over 4,096 transitions against the port's float64 sum
    rounded once);
  * `stability_ratio`: rel 1e-5, empty groups included (float32 segment
    sums against the port's float64 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import energy_lut as j_energy_lut
from repro.core import grouping as jgroup
from repro.core import mac_model as jmac
from repro.core.runner import CnnRunner as JRunner
from repro.core.weight_selection import SelectionConfig as JSel
from repro.nn import cnn as jcnn
from repro_torch.core import baselines as tbase
from repro_torch.core import grouping as tgroup
from repro_torch.core import mac_model as tmac
from repro_torch.core import runner as trunner_mod
from repro_torch.core.runner import CnnRunner as TRunner
from repro_torch.nn import cnn as tcnn
from repro_torch.nn.spec import params_from_numpy
from repro_torch.pipeline.config import SelectionConfig as TSel
from test_torch_schedule import _JaxImages, _TorchImages

BATCH, LR, PRETRAIN = 64, 2e-3, 12
SEL = dict(score_batches=1, accept_batches=1, max_score_candidates=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work in this file runs on one thread: beside the
    suite's parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def j2t(tree):
    return params_from_numpy(jax.device_get(tree), "cpu")


@pytest.fixture(scope="module")
def pair():
    """JAX and port runners on LeNet-5 with the same pretrained state and
    injected per-layer LUTs (as each package's `stats`)."""
    jr = JRunner(jcnn.lenet5(), _JaxImages(), batch_size=BATCH, lr=LR)
    tr = TRunner(tcnn.lenet5(), _TorchImages(), batch_size=BATCH, lr=LR,
                 device="cpu")
    p, s, o, c = jr.init()
    p, s, o, _ = jr.train(p, s, o, c, PRETRAIN)
    base = np.asarray(j_energy_lut.uniform_trace_lut(n_mc=256))
    rng = np.random.default_rng(11)
    luts = {cl.name: (base * (1 + 0.25 * rng.random(256))).astype(np.float32)
            for cl in jr.model.comp_layers}
    jstats = {n: jnp.asarray(v) for n, v in luts.items()}
    tstats = {n: torch.from_numpy(v) for n, v in luts.items()}
    return jr, tr, (p, s, o, c), jstats, tstats


def _run(pair, name, **kw):
    """(JAX result, port result, JAX comp, port comp) of one baseline."""
    jr, tr, (p, s, o, c), jstats, tstats = pair
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_energy_lut, "blended_lut", lambda st: st)
        mp.setattr(trunner_mod, "blended_lut", lambda st: st)
        jkw, tkw = dict(kw), dict(kw)
        if "sel" in kw:
            jkw["sel_cfg"], tkw["sel_cfg"] = JSel(**kw["sel"]), \
                TSel(**kw["sel"])
            del jkw["sel"], tkw["sel"]
        *_, jc, jres = getattr(jbase, name)(jr, p, s, o, c, jstats, **jkw)
        *_, tc, tres = getattr(tbase, name)(tr, j2t(p), j2t(s), j2t(o),
                                            j2t(c), tstats, **tkw)
    return jres, tres, jc, tc


def _hold(jres, tres, jc, tc):
    assert tres.name == jres.name
    assert tres.codebook == [int(v) for v in jres.codebook]
    assert tres.prune_ratio == jres.prune_ratio
    assert tres.acc_before == jres.acc_before
    assert tres.acc_after == jres.acc_after
    np.testing.assert_allclose(tres.energy_before, jres.energy_before,
                               rtol=1e-5)
    np.testing.assert_allclose(tres.energy_after, jres.energy_after,
                               rtol=1e-4)
    np.testing.assert_allclose(tres.energy_saving, jres.energy_saving,
                               rtol=1e-4, atol=1e-6)
    assert list(tc) == list(jc)
    for name in jc:
        for f in ("mask", "codebook", "codebook_k"):
            np.testing.assert_array_equal(tc[name][f].numpy(),
                                          np.asarray(jc[name][f]),
                                          err_msg=f"{name}.{f}")


@pytest.mark.parametrize("name,kw", [
    ("powerpruning_global", dict(k=32, prune_ratio=0.5, finetune_steps=3,
                                 eval_batches=2)),
    ("naive_topk", dict(k=16, finetune_steps=2, eval_batches=2)),
    ("global_strategy", dict(prune_ratio=0.5, k_target=28, finetune_steps=4,
                             eval_batches=2, sel=SEL)),
])
def test_baseline_matches_jax(pair, name, kw):
    jres, tres, jc, tc = _run(pair, name, **kw)
    _hold(jres, tres, jc, tc)
    assert tres.energy_after <= tres.energy_before
    k = kw.get("k", kw.get("k_target"))
    assert len(set(tres.codebook)) == (k if name != "global_strategy"
                                       else len(tres.codebook))
    if name == "global_strategy":
        assert len(tres.codebook) >= k


def test_powerpruning_structure(pair):
    """Every layer carries the one 32-value codebook, and every pruned
    mask removes half its weights (to one weight)."""
    _, tres, _, tc = _run(pair, "powerpruning_global", k=32, prune_ratio=0.5,
                          finetune_steps=1, eval_batches=1)
    assert len(set(tres.codebook)) == 32 and 0 in tres.codebook
    for c in tc.values():
        assert int(c["codebook_k"]) == 32
        assert c["codebook"][:32].tolist() == tres.codebook
        n = c["mask"].numel()
        assert abs(int((c["mask"] == 0).sum()) - n // 2) <= 1
    assert tres.energy_saving > 0


def test_global_lut_counts_matches_jax(pair):
    jr, tr, (p, s, o, c), jstats, tstats = pair
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_energy_lut, "blended_lut", lambda st: st)
        mp.setattr(trunner_mod, "blended_lut", lambda st: st)
        jm = jr.energy_models(p, c, jstats)
        tm = tr.energy_models(j2t(p), j2t(c), tstats)
    jl, jn = jbase._global_lut_counts(jm)
    tl, tn = tbase._global_lut_counts(tm)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tl.dtype == tn.dtype == torch.float32


@pytest.mark.parametrize("n_samples,seed", [(4096, 0), (257, 3)])
def test_weight_static_energy_profile_matches_jax(n_samples, seed):
    want = np.asarray(jmac.weight_static_energy_profile(n_samples=n_samples,
                                                        seed=seed))
    k_a, k_p = jax.random.split(jax.random.PRNGKey(seed))
    a = np.asarray(jax.random.randint(k_a, (n_samples + 1,), -128, 128,
                                      dtype=jnp.int32))
    ps = np.asarray(jax.random.randint(k_p, (n_samples + 1,), 0, 1 << 22,
                                       dtype=jnp.int32))
    got = tmac.weight_static_energy_profile(
        n_samples=n_samples, a_seq=torch.from_numpy(a.copy()),
        p_seq=torch.from_numpy(ps.copy()))
    assert got.shape == (256,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # seeded draws of its own: finite, positive, zero-gated weight cheapest
    own = tmac.weight_static_energy_profile(n_samples=512, seed=seed)
    assert torch.equal(own, tmac.weight_static_energy_profile(
        n_samples=512, seed=seed))
    assert bool(torch.isfinite(own).all()) and float(own.min()) > 0
    assert int(own.argmin()) == 128


@pytest.mark.parametrize("n,n_groups,empty", [(5000, 50, 0), (700, 50, 17),
                                               (64, 7, 3)])
def test_stability_ratio_matches_jax(n, n_groups, empty):
    rng = np.random.default_rng(n)
    live = rng.permutation(n_groups)[:n_groups - empty]
    groups = rng.choice(live, n).astype(np.int32)
    values = (rng.normal(size=n) + 0.3 * groups).astype(np.float32)
    want = float(jgroup.stability_ratio(jnp.asarray(values),
                                        jnp.asarray(groups), n_groups))
    got = tgroup.stability_ratio(torch.from_numpy(values),
                                 torch.from_numpy(groups), n_groups)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
