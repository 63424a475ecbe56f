"""The batched candidate sweep in the port (``search_mode="batched"``): the
stacked-tree helpers, the lockstep weight-set elimination, the runner's
batched train and evaluation steps, K3's candidate axis, and the sweep
itself, against the JAX package and against the port's own serial walk.

Every input is drawn from a seeded ``np.random.default_rng`` or
``torch.Generator``. Tolerances and why:
  * stacked-tree helpers, ``make_codebooks``, the lockstep elimination
    (against JAX's and against the port's serial loop): exact (the same
    integer and float64 host arithmetic on the same arrays);
  * K3's candidate axis against per-candidate ``fake_quant_weights``, and
    its gradient (the mask): exact;
  * ``accuracy_batched`` / ``accuracy_comps`` / ``accuracy_gather`` against
    ``accuracy`` per candidate, and ``train_batched`` against ``train`` per
    candidate (params, state, optimizer state, loss): exact. Every sum whose
    order a candidate axis could change is taken in float64 and rounded
    once (convolutions, dense products, batch norm and its backward, the
    pool, the cross-entropy mean, the global norm), so on the CPU a
    candidate's trajectory is the serial trial's bit for bit;
  * the batched schedule against the port's serial walk: decisions, masks,
    codebooks, accuracies and energies exact (it follows from the above).
The batched schedule against the JAX package's batched sweep is in
test_torch_schedule.py, at the serial schedule's bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qat as jqat
from repro.core import weight_selection as jsel
from repro.core.layer_energy import LayerEnergyModel as JModel
from repro.core.layer_energy import MatmulDims as JDims
from repro_torch._device import tree_leaves, tree_map
from repro_torch.core import qat as tqat
from repro_torch.core import schedule as tsched
from repro_torch.core import weight_selection as tsel
from repro_torch.core.layer_energy import LayerEnergyModel as TModel
from repro_torch.core.layer_energy import MatmulDims as TDims
from repro_torch.core.runner import CnnRunner
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.kernels.fake_quant import fake_quant as tkernel
from repro_torch.kernels.fake_quant import ops as tops
from repro_torch.kernels.fake_quant.ref import candidate_comp
from repro_torch.nn import cnn as tcnn
from repro_torch.nn.layers import QuantConfig
from repro_torch.nn.spec import init_params
from repro_torch.pipeline.config import ScheduleConfig, SelectionConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The float64 CPU work of this file runs on one thread: beside the
    suite's parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_comp(rng, shape, k=0, msr=0):
    """A numpy comp state: a random mask, a k-value codebook, MSR depth."""
    cb = np.zeros(32, np.int32)
    if k:
        vals = np.sort(rng.choice(np.arange(-127, 128), k, replace=False))
        cb[:k], cb[k:] = vals, vals[-1]
    return {"mask": (rng.random(shape) < 0.6).astype(np.float32),
            "codebook": cb, "codebook_k": np.int32(k),
            "msr_bits": np.int32(msr)}


# ------------------------------------------------------ stacked-tree helpers


def test_stacked_tree_helpers_match_jax():
    rng = np.random.default_rng(0)
    trees = [{"a": _np_comp(rng, (3, 4), k=3 * i, msr=i),
              "b": {"w": rng.normal(size=(5,)).astype(np.float32)}}
             for i in range(3)]
    jt = [jax.tree.map(jnp.asarray, t) for t in trees]
    tt = [tree_map(_t, t) for t in trees]

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key in tree
                    for k, v in flat(tree[key], f"{prefix}{key}/").items()}
        return {prefix: np.asarray(tree)}

    def same(port, ref):
        port, ref = flat(port), flat(jax.device_get(ref))
        assert port.keys() == ref.keys()
        for key, r in ref.items():
            assert port[key].shape == r.shape, key
            np.testing.assert_array_equal(port[key], r, err_msg=key)

    js, ts = jqat.stack_pytrees(jt), tqat.stack_pytrees(tt)
    same(ts, js)
    same(tqat.broadcast_pytree(tt[1], 4), jqat.broadcast_pytree(jt[1], 4))
    same(tqat.index_pytree(ts, 2), jqat.index_pytree(js, 2))
    same(tqat.pad_leading(ts, 5), jqat.pad_leading(js, 5))
    same(tqat.pad_leading(ts, 2), jqat.pad_leading(js, 2))
    # broadcast shares, index copies
    bc = tqat.broadcast_pytree(tt[0], 3)
    assert bc["a"]["mask"].stride(0) == 0
    assert bc["a"]["mask"].data_ptr() == tt[0]["a"]["mask"].data_ptr()
    one = tqat.index_pytree(ts, 0)
    assert one["a"]["mask"].data_ptr() != ts["a"]["mask"].data_ptr()


@pytest.mark.parametrize("sets", [
    [[-16, 0, 16], [0], list(range(-8, 8)), []],
    [list(range(-100, 128, 8)), [5, -3, 0, 5]]])
def test_make_codebooks_matches_jax(sets):
    jcb, jk = jqat.make_codebooks(sets)
    tcb, tk = tqat.make_codebooks(sets, device="cpu")
    np.testing.assert_array_equal(tcb.numpy(), np.asarray(jcb))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tcb.dtype == tk.dtype == torch.int32
    for e, values in enumerate(sets):
        cb, k = tqat.make_codebook(values, device="cpu")
        assert torch.equal(tcb[e], cb) and int(tk[e]) == int(k)


# -------------------------------------------------------- lockstep selection


def _energy_models(seed, n):
    """n (JAX, port) pairs of one energy model with the same numbers."""
    out = []
    for i in range(n):
        rng = np.random.default_rng([seed, i])
        counts = rng.integers(0, 400, 256).astype(np.float32)
        counts[rng.random(256) < 0.4] = 0
        counts[128] += 900                               # zeros dominate
        lut = (1.0 + rng.random(256)).astype(np.float32)
        dims = dict(m=64, k=144, n=4096)
        out.append((JModel(f"c{i}", JDims(**dims), jnp.asarray(lut),
                           jnp.asarray(counts)),
                    TModel(f"c{i}", TDims(**dims), torch.from_numpy(lut),
                           torch.from_numpy(counts))))
    return out


def _fake_eval(values, n_batches):
    """A deterministic accuracy of a restricted value set: dropping large
    magnitudes costs more, and some values are essential."""
    missing = set(range(-40, 41, 8)) - set(values)
    penalty = sum(abs(v) for v in missing) * 1e-4 + 0.02 * (24 in missing)
    return round(0.9 - penalty + 0.001 * n_batches, 6)


@pytest.mark.parametrize("seed,k_targets,max_score,accept_batches", [
    (0, (16, 12, 20), 32, 4), (1, (8, 24), 3, 1), (2, (20, 20, 10), 5, 2)])
def test_lockstep_elimination_matches_jax_and_serial(seed, k_targets,
                                                     max_score,
                                                     accept_batches):
    pairs = _energy_models(seed, len(k_targets))
    kw = [dict(k_init=32, k_target=k, delta_acc=0.03,
               max_score_candidates=max_score, accept_batches=accept_batches)
          for k in k_targets]
    jcfgs = [jsel.SelectionConfig(**k) for k in kw]
    tcfgs = [SelectionConfig(**k) for k in kw]
    inits = [tsel.initial_candidate_set(tm.counts, tm.lut, c)
             for (_, tm), c in zip(pairs, tcfgs)]
    calls = []

    def requests(reqs, n_batches):
        calls.append(len(reqs))
        return [_fake_eval(v, n_batches) for _, v in reqs]

    want = jsel.lockstep_backward_elimination(
        [jm for jm, _ in pairs], inits, jcfgs, 0.9, eval_requests=requests)
    n_jax_calls, calls[:] = list(calls), []
    got = tsel.lockstep_backward_elimination(
        [tm for _, tm in pairs], inits, tcfgs, 0.9, eval_requests=requests)
    assert calls == n_jax_calls and max(calls) > 1     # rounds fuse
    for (tv, tr), (jv, jr), (_, tm), init, cfg in zip(got, want, pairs,
                                                      inits, tcfgs):
        sv, sr = tsel.greedy_backward_elimination(
            tm, init, cfg, 0.9, eval_with_codebook=_fake_eval)
        assert tv == jv == sv
        for f in ("layer", "initial", "final", "removed", "essential",
                  "acc_checks"):
            assert getattr(tr, f) == getattr(jr, f) == getattr(sr, f), f
        assert tr.energy_after == sr.energy_after
        np.testing.assert_allclose(tr.energy_after, jr.energy_after,
                                   rtol=1e-12)


# ------------------------------------------------------ K3's candidate axis


def _candidate_group(seed, n=4):
    """ResNet-8's weights with n candidates each: per-candidate weights,
    masks, k and MSR depths on some layers, a shared (stride-0) weight, a
    shared mask without the axis, shared codebook and depth, by-value k."""
    rng = np.random.default_rng(seed)
    ws, comps = [], []
    for i, cl in enumerate(tcnn.resnet8().comp_layers):
        shape = ((cl.kernel, cl.kernel, cl.c_in, cl.c_out)
                 if cl.kind == "conv" else (cl.c_in, cl.c_out))
        per = [_np_comp(rng, shape, k=int(rng.choice([0, 5, 16, 32])),
                        msr=int(rng.choice([0, 3]))) for _ in range(n)]
        c = tqat.stack_pytrees([tree_map(_t, p) for p in per])
        w = _t((rng.normal(size=(n,) + shape) * 0.1).astype(np.float32))
        if i % 3 == 1:              # one weight for every candidate
            w = w[0][None].expand((n,) + shape)
            c["mask"] = c["mask"][0]
        if i % 3 == 2:              # shared codebook and depth, k by value
            c["codebook"] = c["codebook"][0][None].expand(n, 32)
            c["msr_bits"] = c["msr_bits"][0]
            c["codebook_k"] = int(c["codebook_k"][0])
        ws.append(w)
        comps.append(c)
    return ws, comps


def test_k3_candidate_axis_equals_each_candidate_alone():
    n = 4
    ws, comps = _candidate_group(3, n)
    ws = [w.clone().requires_grad_(True) if w.stride(0) else w for w in ws]
    before = tkernel.launches
    got = tqat.fake_quant_weights(ws, comps, cands=n)
    assert tkernel.launches == before            # CPU tensors: the plain K3
    gs = [torch.randn(g.shape, generator=torch.Generator().manual_seed(i))
          for i, g in enumerate(got)]
    sum((g * o).sum() for g, o in zip(gs, got)).backward()
    for w, c, out, g in zip(ws, comps, got, gs):
        assert out.shape == w.shape
        for j in range(n):
            cj = candidate_comp(c, w.ndim - 1, j)
            alone = tqat.fake_quant_weights([w[j].detach()], [cj])[0]
            assert torch.equal(out[j], alone)
            assert torch.equal(out[j], tqat.fake_quant_weight(w[j].detach(),
                                                              cj))
        if w.requires_grad:
            mask = c["mask"] if c["mask"].ndim == w.ndim else c["mask"][None]
            assert torch.equal(w.grad, g * mask)


def _bad(case):
    n = 3
    w = torch.zeros((n, 4, 6))
    c = tqat.stack_pytrees([tqat.identity_comp((4, 6), device="cpu")] * n)
    cands = n
    if case == "axis":
        c["mask"] = torch.ones((n + 1, 4, 6))
    elif case == "w_axis":
        w = torch.zeros((6,))
    elif case == "stride":
        c["mask"] = torch.ones((4, 6, n)).permute(2, 0, 1)
    elif case == "k_axis":
        c["codebook_k"] = torch.zeros((n, 1), dtype=torch.int32)
    elif case == "k_value":
        c["codebook_k"] = torch.tensor([0, 5, 33], dtype=torch.int32)
    elif case == "cands":
        cands = 0
    elif case == "cands_type":
        cands = True
    return [w], [c], cands


@pytest.mark.parametrize("case,match", [
    ("axis", r"group entry 0: mask must have a leading candidate axis of 3"),
    ("w_axis", r"group entry 0: w must have a leading candidate axis"),
    ("stride", r"group entry 0: mask's candidates must be contiguous"),
    ("k_axis", r"group entry 0: k must have a leading candidate axis"),
    ("k_value", r"group entry 0: k=33 not in \[0, 32\]"),
    ("cands", r"cands must be an int in \[1, 256\]"),
    ("cands_type", r"cands must be an int"),
])
def test_group_check_refuses_a_bad_candidate_axis(case, match):
    ws, comps, _ = _bad(None)
    tops.fake_quant_group(ws, comps, 3)
    ws, comps, cands = _bad(case)
    with pytest.raises(ValueError, match=match):
        tops.fake_quant_group(ws, comps, cands)


# ------------------------------------------------- runner: batched steps


def _runner(arch, batch_size=8, noise=0.45):
    return CnnRunner(getattr(tcnn, arch)(),
                     SyntheticImages(seed=3, noise=noise),
                     batch_size=batch_size, lr=2e-3, seed=0, device="cpu")


def _candidates(runner, params, comp):
    """Three comp variants: identity, conv layer 2 pruned 50% at 3 MSR bits,
    pruned 90% with a 5-value codebook."""
    name = runner.model.comp_layers[1].name
    w = runner.model.get_weight(params, name)
    out = []
    for prune, msr, values in ((0.0, 0, ()), (0.5, 3, ()),
                               (0.9, 0, (-64, -8, 0, 8, 64))):
        c = {nm: dict(cc) for nm, cc in comp.items()}
        c[name]["mask"] = tqat.magnitude_prune_mask(w, prune)
        c[name]["msr_bits"] = torch.tensor(msr, dtype=torch.int32)
        if values:
            c[name]["codebook"], c[name]["codebook_k"] = tqat.make_codebook(
                values, device="cpu")
        out.append(c)
    return out


@pytest.mark.parametrize("arch", ["lenet5", "resnet8"])
def test_train_batched_equals_serial_train(arch):
    runner = _runner(arch)
    params, state, opt_state, comp = runner.init()
    cands = _candidates(runner, params, comp)
    n = len(cands)
    p_s, s_s, o_s, loss = runner.train_batched(
        *(tqat.broadcast_pytree(t, n) for t in (params, state, opt_state)),
        tqat.stack_pytrees(cands), 3)
    assert loss.shape == (n,)
    for j, c in enumerate(cands):
        p1, s1, o1, l1 = runner.train(params, state, opt_state, c, 3)
        assert loss[j] == np.float32(l1)
        for tree1, tree_s in ((p1, p_s), (s1, s_s), (o1, o_s)):
            for a, b in zip(tree_leaves(tree1), tree_leaves(tree_s)):
                assert torch.equal(a, b[j])


@pytest.mark.parametrize("arch", ["lenet5", "resnet8"])
def test_batched_accuracies_equal_each_candidate_alone(arch):
    runner = _runner(arch)
    params, state, opt_state, comp = runner.init()
    params, state, opt_state, _ = runner.train(params, state, opt_state,
                                               comp, 2)
    cands = _candidates(runner, params, comp)
    n = len(cands)
    stacked = tqat.stack_pytrees(cands)
    singles = [runner.accuracy(params, state, c, n_batches=2) for c in cands]
    p_s, s_s = (tqat.broadcast_pytree(t, n) for t in (params, state))
    np.testing.assert_array_equal(
        runner.accuracy_batched(p_s, s_s, stacked, n_batches=2), singles)
    np.testing.assert_array_equal(
        runner.accuracy_comps(params, state, stacked, n_batches=2), singles)
    # per-candidate params: three trained copies, gathered out of order
    trained = [runner.train(params, state, opt_state, c, 1)[:2]
               for c in cands]
    p_s = tqat.stack_pytrees([p for p, _ in trained])
    s_s = tqat.stack_pytrees([s for _, s in trained])
    idx = [2, 0, 1, 1]
    comps_e = tree_map(lambda x: x[torch.tensor(idx)], stacked)
    want = [runner.accuracy(*trained[i], cands[i], n_batches=2) for i in idx]
    np.testing.assert_array_equal(
        runner.accuracy_gather(p_s, s_s, comps_e, idx, n_batches=2), want)


@pytest.mark.parametrize("arch", ["lenet5", "resnet8"])
def test_batched_forward_makes_one_grouped_call(arch, monkeypatch):
    """One grouped K3 call for all candidates of a forward (train and
    eval), whatever their number; candidates refuse taps and serve mode."""
    model = getattr(tcnn, arch)()
    params = init_params(0, model.spec, "cpu")
    state = init_params(0, model.state_spec, "cpu")
    calls = []
    real = tqat.fake_quant_weights
    monkeypatch.setattr(tqat, "fake_quant_weights", lambda *a: (
        calls.append(a[2]), real(*a))[1])
    x = torch.zeros((2, 32, 32, 3))
    for n in (1, 5):
        p_s, s_s = (tqat.broadcast_pytree(t, n) for t in (params, state))
        logits, new_state = model.apply(p_s, s_s, x, train=True,
                                        qcfg=QuantConfig.on(), cands=n)
        assert logits.shape == (2, n, 10)
        for a, b in zip(tree_leaves(new_state), tree_leaves(state)):
            assert a.shape == (n,) + tuple(b.shape)
    assert calls == [1, 5]
    with pytest.raises(ValueError, match="fake-quant forward only"):
        model.apply(p_s, s_s, x, qcfg=QuantConfig.on(), cands=5,
                    capture_taps=True)


# ------------------------------------------------------------ the schedule


_SEL = SelectionConfig(k_init=12, k_target=8, delta_acc=0.04,
                       score_batches=1, accept_batches=2,
                       max_score_candidates=4)


def _schedule_cfg(mode, **kw):
    return dataclasses.replace(ScheduleConfig(
        search_mode=mode, prune_ratios=(0.95, 0.5), k_targets=(8, 12),
        msr_bits=(0, 3), delta_acc=0.04, finetune_steps=3,
        trial_finetune_steps=3, eval_batches=2, max_layers=2,
        min_energy_share=0.0), **kw)


@pytest.fixture(scope="module", params=[("lenet5", 32, 1.4, (8, 12)),
                                        ("resnet8", 8, 1.0, (8,))],
                ids=["lenet5", "resnet8"])
def trained(request):
    """A seeded model trained 60 steps and profiled, on images noisy enough
    that the aggressive candidates cost accuracy: each run below rejects
    candidates and accepts others. Also the k targets of its schedule (8
    or 4 candidates a layer)."""
    arch, batch_size, noise, k_targets = request.param
    runner = _runner(arch, batch_size=batch_size, noise=noise)
    params, state, opt_state, comp = runner.init()
    params, state, opt_state, _ = runner.train(params, state, opt_state,
                                               comp, 60)
    stats = runner.profile(params, state, comp, n_batches=1, max_tiles=4)
    return runner, params, state, opt_state, comp, stats, k_targets


def _run(trained, mode, **kw):
    runner, params, state, opt_state, comp, stats, k_targets = trained
    cfg = _schedule_cfg(mode, k_targets=k_targets, **kw)
    return tsched.energy_prioritized_compression(
        runner, params, state, opt_state, comp, stats, cfg, _SEL)


def test_batched_schedule_equals_the_serial_walk(trained):
    out = {mode: _run(trained, mode) for mode in ("serial", "batched")}
    (sp, ss, so, sc, ser), (bp, bs, bo, bc, bat) = out["serial"], \
        out["batched"]
    assert [dataclasses.asdict(d) for d in bat.decisions] == \
        [dataclasses.asdict(d) for d in ser.decisions]
    assert len(ser.decisions) == 2
    assert any(d.accepted for d in ser.decisions)
    assert any(len(d.tried) > 1 for d in ser.decisions)     # and rejected
    for f in ("acc0", "acc_final", "energy_before", "energy_after"):
        assert getattr(bat, f) == getattr(ser, f), f
    assert [dataclasses.asdict(r) for r in bat.selection_reports] == \
        [dataclasses.asdict(r) for r in ser.selection_reports]
    for name in sc:
        for f in ("mask", "codebook", "codebook_k", "msr_bits"):
            assert torch.equal(bc[name][f], sc[name][f]), (name, f)
    for tree_b, tree_s in ((bp, sp), (bs, ss), (bo, so)):
        for a, b in zip(tree_leaves(tree_b), tree_leaves(tree_s)):
            assert torch.equal(a, b)


def test_rejected_candidates_leave_the_callers_objects_untouched(trained):
    _, params, state, opt_state, comp, _, k_targets = trained
    snapshot = [t.clone() for t in tree_leaves((params, state, opt_state,
                                                comp))]
    # floor acc0 + 1: unreachable, every candidate fails
    p2, s2, o2, c2, res = _run(trained, "batched", delta_acc=-1.0,
                               max_layers=1)
    assert all(not d.accepted for d in res.decisions)
    assert len(res.decisions[0].tried) == 4 * len(k_targets)
    assert res.energy_saving == 0.0
    assert p2 is params and s2 is state and o2 is opt_state and c2 is comp
    for a, b in zip(tree_leaves((params, state, opt_state, comp)),
                    snapshot):
        assert torch.equal(a, b)
