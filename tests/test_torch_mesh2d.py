"""The port's steps over a 2 x 2 ("data", "model") mesh of four gloo CPU
processes (one spawn for every check, `tests/_mesh2d_ranks.py`), against
the port's unmeshed steps and the JAX package's unmeshed `make_train_step`
on the same numpy params, comp and batch:

  * two QAT train steps of reduced olmo-1b (remat on: the backward's
    recomputation takes the global activation amax too) and of reduced
    phi3.5-moe with ``moe_local_dispatch=True``: loss rel 1e-5, gradient
    (the first Adam moment after step 1, 0.1 x the clipped gradient)
    rel-L2 1e-4, params after step 2 abs 2e-4 (the LM train-parity bounds
    of `tests/test_torch_lm_train.py`); the int8 activation codes of every
    fake-quant call equal, the data ranks' rows put together;
  * a batch of 3 rows, which does not divide the data axis, replicates:
    the same bounds against the unmeshed step on those rows;
  * the meshed prefill logits and two serve steps (the cache held with
    kv_heads over "model", and on its batch rows alone): logits and cache
    against the unmeshed forward and decode, abs 1e-5 (each rank's
    float32 products run on its own rows);
  * FSDP a layer: each rank's peak of gathered bytes (parameters gathered
    at use and the full gradients being reduced) stays within the
    embedding plus one block's parameters, fake-quantized copy and
    gradient, the dry run's ``gathered_peak_bytes`` of the cell, and below
    the model's parameter bytes, which the step gathered whole before;
    `gather_at_use` gathers the full tensor and its backward gives the
    slice of the data rows' summed gradient, for five layouts;
  * DTensor's ``distribute_tensor`` slices equal `NamedSharding.local`
    (whose order `tests/test_torch_sharding_rules.py` holds to JAX's);
  * a train state saved under 2 x 2 and restored by `elastic_restore` onto
    4 x 1 and 1 x 4: every full tensor equal.

The ranks rendezvous through a file under ``tmp_path``, with a 120 s
collective timeout and a deadline that kills them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mesh2d_ranks import ActCodes, host, rank_checks
from repro.configs import get_config as jget
from repro.core import lm_compress as jlc
from repro.launch import train as jtrain
from repro.models.lm import build_lm as jbuild
from repro.nn.spec import flatten_with_names as jflat
from repro.nn.spec import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.distributed.spawn import run_ranks
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import train as ttrain
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn.spec import abstract_params, params_from_numpy
from repro_torch.nn.transformer import block_matmuls

ARCHS = {"olmo-1b": False, "phi3.5-moe-42b-a6.6b": True}
STEP = dict(qat=True, with_comp=True, remat=True, q_block=16, kv_block=16,
            lr=1e-3)
B, S = 4, 32
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL, LOGIT_ATOL = 1e-5, 1e-4, 2e-4, 1e-5


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def tbatch(toks):
    return {"tokens": torch.as_tensor(toks[:, :-1]),
            "labels": torch.as_tensor(toks[:, 1:])}


def port_steps(arch, item, toks, steps):
    """The port's unmeshed steps: (losses, state after step 1, after the
    last, codes)."""
    model = tbuild(tget(arch).scaled_down(compute_dtype="float32"))
    cfg = ttrain.StepConfig(**STEP)
    p = params_from_numpy(item["params"], "cpu")
    state = {"params": p, "opt": ttrain.make_optimizer(cfg).init(p)}
    step = ttrain.make_train_step(model, cfg)
    losses, first = [], None
    with ActCodes() as rec:
        for i in range(steps):
            state, met = step(state, tbatch(toks),
                              params_from_numpy(item["comp"], "cpu"))
            losses.append({k: float(v) for k, v in met.items()})
            if i == 0:
                first = host(state)
    return losses, first, host(state), rec.codes


def jax_steps(arch, item, toks, steps):
    jm = jbuild(jget(arch).scaled_down(compute_dtype="float32"))
    cfg = jtrain.StepConfig(**STEP)
    p = jax.tree.map(jnp.asarray, item["jparams"])
    state = {"params": p, "opt": jtrain.make_optimizer(cfg).init(p)}
    step = jax.jit(jtrain.make_train_step(jm, cfg))
    losses, first = [], None
    for i in range(steps):
        state, met = step(state, {"tokens": jnp.asarray(toks[:, :-1]),
                                  "labels": jnp.asarray(toks[:, 1:])},
                          item["jcomp"])
        losses.append({k: float(v) for k, v in met.items()})
        if i == 0:
            first = {k: np.asarray(v)
                     for k, v in jflat(jax.device_get(state)).items()}
    return losses, first, {k: np.asarray(v) for k, v in
                           jflat(jax.device_get(state)).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    inputs = {"step_cfg": STEP, "archs": {}}
    for i, (arch, dispatch) in enumerate(ARCHS.items()):
        jm = jbuild(jget(arch).scaled_down(compute_dtype="float32"))
        jp = jinit(jax.random.PRNGKey(i), jm.spec)
        jc = jlc.restrict_all_codebooks(jm, jlc.init_lm_comp(jm),
                                        jlc.symmetric_codebook_values(8))
        toks = np.random.default_rng(i).integers(
            0, jm.cfg.vocab, (B, S + 1)).astype(np.int32)
        inputs["archs"][arch] = {
            "params": jax.device_get(jp), "comp": jax.device_get(jc),
            "toks": toks, "dispatch": dispatch}
    work = tmp_path_factory.mktemp("mesh2d")
    ranks = run_ranks(rank_checks, 4, args=(inputs, str(work / "ckpt")),
                      backend="gloo", timeout_s=120, deadline_s=300,
                      workdir=str(work))
    out = {"ranks": ranks, "port": {}, "jax": {}, "inputs": inputs}
    for arch, item in inputs["archs"].items():
        out["port"][arch] = port_steps(arch, item, item["toks"], 2)
        out["jax"][arch] = jax_steps(
            arch, dict(item, jparams=item["params"], jcomp=item["comp"]),
            item["toks"], 2)
    out["port"]["replicated"] = port_steps(
        "olmo-1b", inputs["archs"]["olmo-1b"],
        inputs["archs"]["olmo-1b"]["toks"][:3], 1)
    torch.set_num_threads(n)
    return out


def check_state(losses, first, last, want_losses, want_first, want_last):
    for got, want in zip(losses, want_losses):
        for k in want:
            assert abs(got[k] - want[k]) <= LOSS_RTOL * max(abs(want[k]),
                                                            1e-30), k
    mu = [k for k in want_first if k.startswith("opt/mu/")]
    assert mu
    for k in mu:
        assert rel_l2(first[k], want_first[k]) < GRAD_RTOL, k
    for k in want_last:
        if k.startswith("params/"):
            np.testing.assert_allclose(last[k], want_last[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_meshed_train_step_matches_the_unmeshed_port(runs, arch):
    r0 = runs["ranks"][0][arch]
    losses, first, last, _ = runs["port"][arch]
    for r in runs["ranks"]:       # every rank reports the global metrics
        assert r[arch]["losses"] == r0["losses"]
    check_state(r0["losses"], r0["first"], r0["last"], losses, first, last)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_meshed_train_step_matches_jax(runs, arch):
    r0 = runs["ranks"][0][arch]
    losses, first, last = runs["jax"][arch]
    check_state(r0["losses"], r0["first"], r0["last"], losses, first, last)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_activation_codes_equal(runs, arch):
    want = runs["port"][arch][3]
    by_data = {r["coords"]["data"]: r[arch]["codes"] for r in runs["ranks"]
               if r["coords"]["model"] == 0}
    assert len(want) == len(by_data[0]) == len(by_data[1]) > 0
    for i, w in enumerate(want):
        got = np.concatenate([by_data[0][i], by_data[1][i]])
        assert got.shape == w.shape and np.array_equal(got, w), i


def test_batch_that_does_not_divide_replicates(runs):
    r0 = runs["ranks"][0]["replicated"]
    losses, first, last, _ = runs["port"]["replicated"]
    check_state(r0["losses"], r0["last"], r0["last"], losses, last, last)


def test_meshed_prefill_and_serve_logits(runs):
    item = runs["inputs"]["archs"]["olmo-1b"]
    model = tbuild(tget("olmo-1b").scaled_down(compute_dtype="float32"))
    params = params_from_numpy(item["params"], "cpu")
    prompt = torch.as_tensor(item["toks"][:, :16])
    with torch.no_grad():
        logits, _ = model.forward(params, prompt)
        _, cache = model.prefill(params, prompt, 24,
                                 cache_dtype=torch.float32)
        steps = []
        for t in range(2):
            lg, cache = model.decode_step(
                params, cache, torch.as_tensor(item["toks"][:, 16 + t:17 + t]))
            steps.append(lg.numpy())
    r0 = runs["ranks"][0]
    np.testing.assert_allclose(r0["prefill_logits"], logits.numpy(), rtol=0,
                               atol=LOGIT_ATOL)
    want_cache = host(cache)
    for name in ("heads", "rows"):
        got = r0["served"][name]
        for a, b in zip(got["logits"], steps):
            np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_ATOL)
        for k, v in want_cache.items():
            np.testing.assert_allclose(got["cache"][k], v, rtol=0,
                                       atol=LOGIT_ATOL, err_msg=k)
    # kv_heads over "model": each rank holds 2 of 4 rows and 1 of 2 heads
    for r in runs["ranks"]:
        assert r["served"]["heads"]["local_k"][1:4] == (2, 24, 1)
        assert r["served"]["rows"]["local_k"][1:4] == (2, 24, 2)


def test_dtensor_slices_equal_the_port_slices(runs):
    for r in runs["ranks"]:
        assert all(r["dtensor"].values()), r["dtensor"]
    # [Shard(0), Shard(0)] on (data, model): position (0, 0) holds rows 0-1
    r0 = next(r for r in runs["ranks"] if r["coords"] == {"data": 0,
                                                          "model": 0})
    assert r0["rank"] == 0
    assert r0["rows_of_shard0_shard0"] == [0.0, 24.0]


@pytest.mark.parametrize("shape", ["4x1", "1x4"])
def test_elastic_restore_across_mesh_shapes(runs, shape):
    for r in runs["ranks"]:
        got = r["restored"][shape]
        assert got["step"] == 3
        assert got["equal"] and got["local_shapes"]
        assert got["sharded_leaves"] > 0
        assert list(got["mesh"].values()) == [int(n) for n in
                                              shape.split("x")]


# ------------------------------------------------------------ FSDP a layer


def nbytes(tree):
    return sum(t.numel() * t.element_size()
               for t in ttrain.tree_leaves(tree))


def one_block_bound(model, train=True):
    """The embedding plus one block's parameters and, in training, its
    fake-quantized copy and its gradient (each reduced model here has one
    stacked group, float32)."""
    params = abstract_params(model.spec)
    block = params["blocks"]["g0"]
    depth = model.n_rep
    layer = nbytes(block) // depth
    fq = sum(nbytes(block[u.split("/")[0]][u.split("/")[1]])
             for u in block_matmuls(block)) // depth
    embed = max(nbytes(params["embed"]), nbytes(params.get("lm_head", {})))
    return embed + layer + (fq + layer if train else 0), nbytes(params)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_meshed_train_step_gathers_one_block_at_a_time(runs, arch):
    model = tbuild(tget(arch).scaled_down(compute_dtype="float32"))
    bound, whole = one_block_bound(model)
    assert tdry.gathered_peak_bytes(model, "train") == bound
    for r in runs["ranks"]:
        peaks = r[arch]["gathered_peaks"]
        assert len(peaks) == 2 and min(peaks) > 0, peaks
        assert max(peaks) <= bound, (r["rank"], peaks, bound)
        assert max(peaks) < whole, (r["rank"], peaks, whole)


def test_replicated_batch_and_serving_steps_gather_one_block(runs):
    model = tbuild(tget("olmo-1b").scaled_down(compute_dtype="float32"))
    bound, whole = one_block_bound(model)
    serve_bound, _ = one_block_bound(model, train=False)
    for r in runs["ranks"]:
        assert 0 < max(r["replicated"]["gathered_peaks"]) <= bound
        assert 0 < r["prefill_gathered_peak"] <= serve_bound < whole
        assert len(r["serve_gathered_peaks"]) == 4
        assert 0 < max(r["serve_gathered_peaks"]) <= serve_bound


def test_gather_backward_is_the_slice_of_the_summed_gradient(runs):
    for r in runs["ranks"]:
        checks = r["gather_backward"]
        assert len(checks) == 6 and all(checks.values()), (r["rank"],
                                                            checks)
