"""The port's steps over a 2 x 2 ("data", "model") mesh of four gloo CPU
processes (one spawn for every check, `tests/_mesh2d_ranks.py`), against
the port's unmeshed steps and the JAX package's unmeshed `make_train_step`
on the same numpy params, comp and batch:

  * two QAT train steps of reduced olmo-1b (remat on: the backward's
    recomputation takes the global activation amax too), of reduced
    phi3.5-moe with ``moe_local_dispatch=True``, on the default layout
    (each model rank runs its 2 of the 4 experts) and with tensor-parallel
    experts (``expert=None, moe_ff=model``: every expert at half its hidden
    width), and of reduced moonshot-v1-16b-a3b (its shared expert's hidden
    width split too), all with attention, the FFN and the vocabulary
    tensor-parallel over "model": loss rel 1e-5, gradient (the first Adam
    moment after step 1, 0.1 x the clipped gradient) rel-L2 1e-4, params
    after step 2 abs 2e-4 (the LM train-parity bounds of
    `tests/test_torch_lm_train.py`); the int8 activation codes of every
    fake-quant call equal, the data ranks' rows and the model ranks'
    features (heads, hidden width, experts) put together;
  * the same step on two other layouts: storage only (``--rules
    heads=None,mlp=None,vocab=None,kv_heads=None``) and K/V heads
    replicated while the query heads split; a batch of 3 rows, which does
    not divide the data axis, replicates: the same bounds;
  * a rank's matmul FLOPs (`FlopCounterMode`) are 1/4 of the unmeshed
    step's where every unit splits over "model" (phi3.5-moe's experts on
    both MoE layouts; its router, on every model rank, 1/2), 1/2 on the
    storage-only layout, and equal the dry run's ``flops``
    (`launch.dryrun.step_costs`) of the same reduced cell; the bytes and
    count of each kind of collective a rank ran equal the dry run's
    ``collectives``;
  * the meshed prefill logits (each rank's rows x vocabulary chunk,
    `logits_sharding`) and two serve steps (the cache held with kv_heads
    over "model", and on its batch rows alone): logits and cache against
    the unmeshed forward and decode, abs 1e-5; phi3.5-moe's on both MoE
    layouts, with the prefill's FLOPs and collectives and a serve step's
    collectives equal to the dry run's;
  * FSDP a layer: each rank's peak of gathered bytes (parameters gathered
    at use, a tensor-parallel unit's model chunk, and the full gradients
    being reduced) stays within the embedding plus one block's
    parameters, fake-quantized copy and gradient, the dry run's
    ``gathered_peak_bytes`` of the cell, and below the model's parameter
    bytes (the MoE's below what its cell gathered with the experts whole);
    `gather_at_use` gathers the full tensor and its backward gives
    the slice of the data rows' summed gradient, for five layouts;
  * DTensor's ``distribute_tensor`` slices equal `NamedSharding.local`
    (whose order `tests/test_torch_sharding_rules.py` holds to JAX's);
  * a train state saved under 2 x 2 and restored by `elastic_restore` onto
    4 x 1 and 1 x 4: every full tensor equal;
  * the recurrent mixers and the encoder-decoder split over "model":
    reduced mamba2-1.3b (its SSM by heads), recurrentgemma-2b at one
    (rglru, rglru, local) repeat (the RG-LRU by channels) and
    whisper-large-v3 (its encoder layers and cross-attention by heads),
    two train steps each against the port's unmeshed steps at the bounds
    above with the codes equal; against JAX on JAX's own int8 activation
    rounding (its codes, recorded without remat in a thread beside the
    ranks, replayed into a meshed run: each package's own rounding flips
    codes at these sizes, `tests/test_torch_lm_recurrent_train.py`); a
    rank's FLOPs equal to the dry run's, a quarter of the unmeshed step's
    in each split unit (mamba2's SSD scores, one a group, on every model
    rank); collectives equal to the dry run's; gathered bytes within the
    dry run's bound and below the storage-only layout's; a meshed prefill
    and two serve steps (the recurrent caches and cross K/V held split)
    against the unmeshed forward and decode, abs 1e-5, the prefill's
    FLOPs and collectives and a serve step's collectives equal to the dry
    run's; and the SSM's head split read off its columns and channels.

The ranks rendezvous through a file under ``tmp_path``, with a 120 s
collective timeout and a deadline that kills them.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mesh2d_ranks import (
    ENC_LEN,
    MOE_ARCH,
    MOE_LAYOUTS,
    PROMPT,
    SPLIT_ARCHS,
    STORAGE_ONLY,
    TP_EXPERTS,
    ActCodes,
    host,
    rank_checks,
    reduced,
)
from repro.configs import get_config as jget
from repro.core import lm_compress as jlc
from repro.core import qat as jqat
from repro.launch import train as jtrain
from repro.models.lm import build_lm as jbuild
from repro.nn.spec import flatten_with_names as jflat
from repro.nn.spec import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.spawn import run_ranks
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import train as ttrain
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn.spec import abstract_params, params_from_numpy
from repro_torch.nn.transformer import block_matmuls

ARCHS = {"olmo-1b": False, MOE_ARCH: True, "moonshot-v1-16b-a3b": True,
         **{arch: False for arch in SPLIT_ARCHS}}
# the meshed train runs held to the unmeshed steps: name -> (arch, rules
# overrides)
DECODER_RUNS = {"olmo-1b": ("olmo-1b", {}), MOE_ARCH: (MOE_ARCH, {}),
                "phi3.5-moe-tp-experts": (MOE_ARCH, TP_EXPERTS),
                "moonshot-v1-16b-a3b": ("moonshot-v1-16b-a3b", {})}
RUNS = {**DECODER_RUNS, **{arch: (arch, {}) for arch in SPLIT_ARCHS}}
# fake-quant calls on features split over "model" in two steps (forward
# and remat's recompute): a decoder layer's attention output and FFN
# hidden; an SSM layer's out_proj input; an RG-LRU layer's out_proj input
# and FFN hidden; whisper's encoder layer's two, decoder layer's three
# (cross-attention's output too)
SPLIT_CALLS = {**{run: 16 for run in DECODER_RUNS}, "mamba2-1.3b": 8,
               "recurrentgemma-2b": 24, "whisper-large-v3": 40}
STEP = dict(qat=True, with_comp=True, remat=True, q_block=16, kv_block=16,
            lr=1e-3)
B, S = 4, 32
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL, LOGIT_ATOL = 1e-5, 1e-4, 2e-4, 1e-5


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def tbatch(toks, enc=None):
    out = {"tokens": torch.as_tensor(toks[:, :-1]),
           "labels": torch.as_tensor(toks[:, 1:])}
    if enc is not None:
        out["enc_embeds"] = torch.as_tensor(enc[:len(toks)])
    return out


def port_steps(arch, item, toks, steps):
    """The port's unmeshed steps: (losses, state after step 1, after the
    last, codes, the first step's matmul FLOPs)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = tbuild(reduced(arch))
    cfg = ttrain.StepConfig(**STEP)
    p = params_from_numpy(item["params"], "cpu")
    state = {"params": p, "opt": ttrain.make_optimizer(cfg).init(p)}
    step = ttrain.make_train_step(model, cfg)
    losses, first, flops = [], None, None
    with ActCodes() as rec:
        for i in range(steps):
            with FlopCounterMode(display=False) as fc:
                state, met = step(state, tbatch(toks, item.get("enc")),
                                  params_from_numpy(item["comp"], "cpu"))
            losses.append({k: float(v) for k, v in met.items()})
            if i == 0:
                first, flops = host(state), fc.get_total_flops()
    return losses, first, host(state), rec.codes, flops


def jax_steps(arch, item, toks, steps, record=None):
    """The JAX package's unmeshed steps: (losses, state after step 1,
    after the last). ``record`` (a list): run without remat, collecting the
    int8 codes of every activation fake-quant call in order (an ordered
    host callback inside the jitted step)."""
    jm = jbuild(jget(arch).scaled_down(compute_dtype="float32",
                                       **SPLIT_ARCHS.get(arch, {})))
    cfg = jtrain.StepConfig(**dict(STEP, remat=record is None))
    p = jax.tree.map(jnp.asarray, item["jparams"])
    state = {"params": p, "opt": jtrain.make_optimizer(cfg).init(p)}
    real = jqat.fake_quant_act

    def recording(a):
        scale = jnp.maximum(jnp.max(jnp.abs(a)), 1e-8) / jqat.QMAX
        codes = jnp.clip(jnp.round(a / scale), -jqat.QMAX, jqat.QMAX)
        jax.debug.callback(lambda c: record.append(np.asarray(
            c, dtype=np.int8)), codes, ordered=True)
        return real(a)

    if record is not None:
        jqat.fake_quant_act = recording
    try:
        step = jax.jit(jtrain.make_train_step(jm, cfg))
        losses, first = [], None
        for i in range(steps):
            state, met = step(state, {k: jnp.asarray(v.numpy()) for k, v in
                                      tbatch(toks, item.get("enc")).items()},
                              item["jcomp"])
            losses.append({k: float(v) for k, v in met.items()})
            if i == 0:
                first = {k: np.asarray(v)
                         for k, v in jflat(jax.device_get(state)).items()}
        jax.effects_barrier()
    finally:
        jqat.fake_quant_act = real
    return losses, first, {k: np.asarray(v) for k, v in
                           jflat(jax.device_get(state)).items()}


def in_port_order(codes, cfg):
    """JAX's recorded activation codes in the order the port's step makes
    its calls. The encoder-decoder differs: the cross K/V projections'
    input is the encoder output, the same in every decoder layer, and JAX
    quantizes it once, before the decoder's layer scan; the port quantizes
    it in each layer, after the self-attention (per step: 6 calls an
    encoder layer, then that one pair, then 8 a decoder layer)."""
    if not cfg.encoder_decoder:
        return codes
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers
    per = 6 * n_enc + 2 + 8 * n_dec
    out = []
    for s0 in range(0, len(codes), per):
        step = codes[s0:s0 + per]
        i = 6 * n_enc
        out += step[:i]
        pair = step[i:i + 2]
        for i in range(i + 2, per, 8):
            out += step[i:i + 4] + pair + step[i + 4:i + 8]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    inputs = {"step_cfg": STEP, "archs": {}, "runs": RUNS}
    for i, (arch, dispatch) in enumerate(ARCHS.items()):
        jm = jbuild(jget(arch).scaled_down(compute_dtype="float32",
                                           **SPLIT_ARCHS.get(arch, {})))
        jp = jinit(jax.random.PRNGKey(i), jm.spec)
        jc = jlc.restrict_all_codebooks(jm, jlc.init_lm_comp(jm),
                                        jlc.symmetric_codebook_values(8))
        rng = np.random.default_rng(i)
        toks = rng.integers(0, jm.cfg.vocab, (B, S + 1)).astype(np.int32)
        inputs["archs"][arch] = {
            "params": jax.device_get(jp), "comp": jax.device_get(jc),
            "toks": toks, "dispatch": dispatch,
            "enc": rng.standard_normal((B, ENC_LEN, jm.cfg.d_model)).astype(
                np.float32) if jm.cfg.encoder_decoder else None}
    work = tmp_path_factory.mktemp("mesh2d")
    # the split archs are held to JAX on its own activation rounding: its
    # codes, recorded without remat while the ranks run their other
    # checks, are replayed into a meshed run (`wait_for_codes`)
    codes_file = work / "jax_codes.npz"
    inputs["jax_codes_file"] = str(codes_file)
    jax_rounding = {}

    def record():
        try:
            codes = {}
            for arch in SPLIT_ARCHS:
                item, got = inputs["archs"][arch], []
                jax_rounding[arch] = jax_steps(
                    arch, dict(item, jparams=item["params"],
                               jcomp=item["comp"]), item["toks"], 2,
                    record=got)
                codes[arch] = in_port_order(got, reduced(arch))
            with open(work / "jax_codes.part", "wb") as f:
                np.savez(f, **{f"{a}|{i}": c for a, cs in codes.items()
                               for i, c in enumerate(cs)})
            os.replace(work / "jax_codes.part", codes_file)
        except BaseException as e:
            (work / "jax_codes.npz.failed").write_text(repr(e))
            raise

    with ThreadPoolExecutor(1) as pool:
        recorded = pool.submit(record)
        ranks = run_ranks(rank_checks, 4, args=(inputs, str(work / "ckpt")),
                          backend="gloo", timeout_s=120, deadline_s=300,
                          workdir=str(work))
        recorded.result()
    out = {"ranks": ranks, "port": {}, "jax": jax_rounding,
           "inputs": inputs}
    for arch, item in inputs["archs"].items():
        out["port"][arch] = port_steps(arch, item, item["toks"], 2)
        if arch not in SPLIT_ARCHS:
            out["jax"][arch] = jax_steps(
                arch, dict(item, jparams=item["params"],
                           jcomp=item["comp"]), item["toks"], 2)
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


@pytest.mark.parametrize("run", list(RUNS))
def test_meshed_train_step_matches_the_unmeshed_port(runs, run):
    r0 = runs["ranks"][0][run]
    losses, first, last = runs["port"][RUNS[run][0]][:3]
    for r in runs["ranks"]:       # every rank reports the global metrics
        assert r[run]["losses"] == r0["losses"]
    check_state(r0["losses"], r0["first"], r0["last"], losses, first, last)


@pytest.mark.parametrize("run", list(RUNS))
def test_meshed_train_step_matches_jax(runs, run):
    """The split archs against JAX on its own int8 activation rounding
    (each package rounds its own sums: an activation within an ulp of a
    rounding boundary takes the next code in one of them, and one code
    moves an updated weight by up to 2 lr, `tests/test_torch_lm_recurrent
    _train.py`), without remat; the others on their own rounding."""
    r0 = runs["ranks"][0][f"{run}-jax-rounding" if run in SPLIT_ARCHS
                          else run]
    losses, first, last = runs["jax"][RUNS[run][0]]
    check_state(r0["losses"], r0["first"], r0["last"], losses, first, last)


def put_together(parts, want):
    """One fake-quant call's codes from the ranks ({(data, model): codes})
    as the unmeshed call's: the data ranks' rows concatenated; a call on
    features split over "model" (the attention output before wo, the FFN
    hidden, the experts' hidden: its experts or its hidden width) has its
    model ranks' chunks concatenated along that axis, one computed whole is
    the same on both."""
    rows = []
    for d in (0, 1):
        a, b = parts[(d, 0)], parts[(d, 1)]
        if a.shape[1:] == want.shape[1:]:
            assert np.array_equal(a, b)
            rows.append(a)
        else:
            ax = next(i for i in range(1, a.ndim)
                      if a.shape[i] != want.shape[i])
            rows.append(np.concatenate([a, b], axis=ax))
    return np.concatenate(rows)


@pytest.mark.parametrize("run", list(RUNS))
def test_activation_codes_equal(runs, run):
    want = runs["port"][RUNS[run][0]][3]
    by_pos = {(r["coords"]["data"], r["coords"]["model"]): r[run]["codes"]
              for r in runs["ranks"]}
    assert all(len(c) == len(want) > 0 for c in by_pos.values())
    split = 0
    for i, w in enumerate(want):
        parts = {k: v[i] for k, v in by_pos.items()}
        split += parts[(0, 0)].shape[1:] != w.shape[1:]
        got = put_together(parts, w)
        assert got.shape == w.shape and np.array_equal(got, w), i
    assert split == SPLIT_CALLS[run]


def test_batch_that_does_not_divide_replicates(runs):
    r0 = runs["ranks"][0]["replicated"]
    losses, first, last = runs["port"]["replicated"][:3]
    check_state(r0["losses"], r0["last"], r0["last"], losses, last, last)


@pytest.mark.parametrize("layout", ["storage_only", "kv_replicated"])
def test_other_layouts_match_the_unmeshed_port(runs, layout):
    r0 = runs["ranks"][0][layout]
    losses, first = runs["port"]["olmo-1b"][:2]
    for r in runs["ranks"]:
        assert r[layout]["losses"] == r0["losses"]
    check_state(r0["losses"], r0["last"], r0["last"], losses[:1], first,
                first)


def olmo_model():
    return tbuild(tget("olmo-1b").scaled_down(compute_dtype="float32"))


MESH = tsh.AbstractMesh((2, 2), ("data", "model"))


def dry(model, rules=tsh.DEFAULT_RULES, kind="train", rows=B, seq=S,
        **kw):
    return tdry.step_costs(model, MESH, rules, kind, rows, seq,
                           ttrain.StepConfig(**STEP), **kw)


@pytest.mark.parametrize("layout,fraction", [("olmo-1b", 4),
                                             ("storage_only", 2)])
def test_rank_flops_split_over_the_model_axis(runs, layout, fraction):
    """Every unit of olmo-1b (attention, FFN, read-out) splits over
    "model": a rank does 1/4 of the unmeshed step's products (half the
    rows, half the features); computed whole, 1/2."""
    unmeshed = runs["port"]["olmo-1b"][4]
    rules = tsh.DEFAULT_RULES.replace(**STORAGE_ONLY) \
        if layout == "storage_only" else tsh.DEFAULT_RULES
    want = dry(olmo_model(), rules)["flops"]
    for r in runs["ranks"]:
        got = r[layout]["counted"]["flops"]
        assert got * fraction == unmeshed
        assert got == want["total"]


def moe_model(arch=MOE_ARCH):
    return tbuild(tget(arch).scaled_down(compute_dtype="float32"))


def rules_of(run):
    layout = RUNS[run][1]
    return tsh.DEFAULT_RULES.replace(**layout) if layout \
        else tsh.DEFAULT_RULES


@pytest.mark.parametrize("run", [MOE_ARCH, "phi3.5-moe-tp-experts"])
def test_phi35_moe_experts_split_over_the_model_axis(runs, run):
    """phi3.5-moe: a rank runs 1/4 of the unmeshed step's expert products
    (half the rows; half the experts, or every expert at half its hidden
    width), as of attention and the read-out; the router, on every model
    rank, 1/2. The counted FLOPs equal the dry run's, unit by unit
    summed."""
    model = moe_model()
    meshed = dry(model, rules_of(run))["flops"]["by_unit"]
    alone = tdry.step_costs(model, tsh.AbstractMesh((1, 1), ("data",
                                                             "model")),
                            None, "train", B, S,
                            ttrain.StepConfig(**STEP))["flops"]
    assert alone["total"] == runs["port"][MOE_ARCH][4]
    assert {"moe", "router"} <= set(alone["by_unit"])
    for unit, n in alone["by_unit"].items():
        assert meshed[unit] * (2 if unit == "router" else 4) == n, unit
    for r in runs["ranks"]:
        assert r[run]["counted"]["flops"] == sum(meshed.values())


@pytest.mark.parametrize("layout", ["olmo-1b", "phi3.5-moe-42b-a6.6b",
                                    "storage_only", "kv_replicated",
                                    "phi3.5-moe-tp-experts",
                                    "moonshot-v1-16b-a3b", *SPLIT_ARCHS])
def test_collective_bytes_equal_the_dry_run(runs, layout):
    arch = "olmo-1b" if layout in ("storage_only", "kv_replicated") \
        else RUNS[layout][0]
    rules = {"storage_only": tsh.DEFAULT_RULES.replace(**STORAGE_ONLY),
             "kv_replicated": tsh.DEFAULT_RULES.replace(kv_heads=None)
             }.get(layout) or rules_of(layout)
    model = tbuild(reduced(arch))
    want = dry(model, rules)["collectives"]
    for r in runs["ranks"]:
        assert r[layout]["counted"]["collectives"] == want, r["rank"]
    if layout == "olmo-1b":   # the float64 tensor-parallel all-reduces
        assert want["all-reduce"]["bytes"] > 50 * dry(
            model, tsh.DEFAULT_RULES.replace(**STORAGE_ONLY))[
                "collectives"]["all-reduce"]["bytes"]


def test_prefill_collectives_equal_the_dry_run(runs):
    want = dry(olmo_model(), kind="prefill", seq=16,
               param_dtype=torch.float32)["collectives"]
    for r in runs["ranks"]:
        assert r["prefill_collectives"] == want


@pytest.mark.parametrize("layout", list(MOE_LAYOUTS))
def test_meshed_moe_prefill_and_serve(runs, layout):
    """phi3.5-moe's meshed prefill and two serve steps on both MoE layouts:
    logits against the unmeshed forward and decode, abs 1e-5; the
    prefill's FLOPs and collectives and a serve step's collectives equal to
    the dry run's."""
    item = runs["inputs"]["archs"][MOE_ARCH]
    model = moe_model()
    params = params_from_numpy(item["params"], "cpu")
    prompt = torch.as_tensor(item["toks"][:, :16])
    with torch.no_grad():
        want = [model.forward(params, prompt)[0].numpy()]
        _, cache = model.prefill(params, prompt, 24,
                                 cache_dtype=torch.float32)
        for t in range(2):
            lg, cache = model.decode_step(
                params, cache, torch.as_tensor(item["toks"][:, 16 + t:17 + t]))
            want.append(lg.numpy())
    for got, w in zip(runs["ranks"][0]["moe_serving"][layout]["logits"],
                      want):
        np.testing.assert_allclose(got, w, rtol=0, atol=LOGIT_ATOL)
    rules = tsh.DEFAULT_RULES.replace(**MOE_LAYOUTS[layout]) \
        if MOE_LAYOUTS[layout] else tsh.DEFAULT_RULES
    prefill = dry(model, rules, kind="prefill", seq=16,
                  param_dtype=torch.float32)
    decode = dry(model, rules, kind="decode", seq=24,
                 param_dtype=torch.float32)
    for r in runs["ranks"]:
        got = r["moe_serving"][layout]
        assert got["prefill"]["flops"] == prefill["flops"]["total"]
        assert got["prefill"]["collectives"] == prefill["collectives"]
        assert got["decode_collectives"] == decode["collectives"]


def test_meshed_prefill_and_serve_logits(runs):
    item = runs["inputs"]["archs"]["olmo-1b"]
    model = olmo_model()
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
    # a rank's block of the logits: 2 of 4 rows, half the vocabulary
    # (logits_sharding, JAX's logits_constraint); kv_heads over "model":
    # each rank holds 2 of 4 rows and 1 of 2 heads
    for r in runs["ranks"]:
        assert r["prefill_block"] == (2, 16, model.cfg.padded_vocab // 2)
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
    stacked group, float32), on the 2 x 2 mesh: the tied table, the
    attention and FFN leaves and the MoE's experts and shared experts
    (tensor-parallel: half the experts, or half their hidden width) count
    half, the rest (norms, the router) whole; and the model's parameter
    bytes."""
    params = abstract_params(model.spec)
    block = params["blocks"]["g0"]
    depth = model.n_rep

    def at_use(sub, key, leaf):
        split = sub in ("attn", "mlp", "embed") \
            or (sub == "moe" and key != "router")
        return nbytes(leaf) // (2 if split else 1)

    layer = sum(at_use(sub, k, leaf) for sub, v in block.items()
                for k, leaf in v.items()) // depth
    fq = sum(at_use(*u.split("/"), block[u.split("/")[0]][u.split("/")[1]])
             for u in block_matmuls(block)) // depth
    embed = max(at_use("embed", "table", params["embed"]),
                nbytes(params.get("lm_head", {})) // 2)
    return embed + layer + (fq + layer if train else 0), nbytes(params)


@pytest.mark.parametrize("run", list(DECODER_RUNS))
def test_meshed_train_step_gathers_one_block_at_a_time(runs, run):
    model = tbuild(tget(RUNS[run][0]).scaled_down(compute_dtype="float32"))
    bound, whole = one_block_bound(model)
    assert tdry.gathered_peak_bytes(model, "train", MESH,
                                    rules_of(run)) == bound
    # the same step with the experts gathered whole held more
    experts_whole = tdry.gathered_peak_bytes(
        model, "train", MESH, tsh.DEFAULT_RULES.replace(expert=None))
    for r in runs["ranks"]:
        peaks = r[run]["gathered_peaks"]
        assert len(peaks) == 2 and min(peaks) > 0, peaks
        assert max(peaks) <= bound, (r["rank"], peaks, bound)
        assert max(peaks) < whole, (r["rank"], peaks, whole)
        if "moe" in model.spec["blocks"]["g0"]:
            assert max(peaks) < experts_whole, (r["rank"], peaks)


def test_replicated_batch_and_serving_steps_gather_one_block(runs):
    model = olmo_model()
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


# ------------------------------------ the recurrent mixers and the encoder


# the units of each split arch whose products a rank runs a quarter of
# (half the rows, half the features): recurrentgemma's MQA K/V projections
# run whole on each model rank, and mamba2's SSD scores are one a group
QUARTER = {"mamba2-1.3b": ("readout",),
           "recurrentgemma-2b": ("attention", "ffn", "mixer", "readout"),
           "whisper-large-v3": ("attention", "ffn", "projections",
                                "readout")}


@pytest.mark.parametrize("arch", list(SPLIT_ARCHS))
def test_split_units_flops_equal_the_dry_run(runs, arch):
    """A rank of the 2 x 2 mesh runs the dry run's products: a quarter of
    the unmeshed step's in each split unit (mamba2's mixer: a quarter but
    for its C B^T scores, one a group, which every model rank runs), the
    unmeshed step's being the 1 x 1 dry run's."""
    model = tbuild(reduced(arch))
    meshed = dry(model)["flops"]
    alone = tdry.step_costs(model, tsh.AbstractMesh((1, 1), ("data",
                                                             "model")),
                            None, "train", B, S,
                            ttrain.StepConfig(**STEP))["flops"]
    assert alone["total"] == runs["port"][arch][4]
    for r in runs["ranks"]:
        assert r[arch]["counted"]["flops"] == meshed["total"], r["rank"]
    for unit in QUARTER[arch]:
        assert meshed["by_unit"][unit] * 4 == alone["by_unit"][unit], unit
    if arch == "mamba2-1.3b":
        sd = model.cfg.ssm_dims()
        scores = 2 * B * (S // sd.chunk) * sd.chunk ** 2 * sd.d_state \
            * model.n_rep * 4           # forward, recompute, two gradients
        assert 4 * meshed["by_unit"]["mixer"] \
            == alone["by_unit"]["mixer"] + scores
    else:
        assert meshed["xla_only"] == 0


@pytest.mark.parametrize("arch", list(SPLIT_ARCHS))
def test_split_archs_gather_within_the_dry_run(runs, arch):
    model = tbuild(reduced(arch))
    bound = tdry.gathered_peak_bytes(model, "train", MESH)
    whole = nbytes(abstract_params(model.spec))
    assert bound < whole
    storage = tdry.gathered_peak_bytes(model, "train", MESH, tsh.DEFAULT_RULES
                                       .replace(**STORAGE_ONLY, inner=None))
    assert bound < storage
    for r in runs["ranks"]:
        peaks = r[arch]["gathered_peaks"]
        assert len(peaks) == 2 and 0 < max(peaks) <= bound, (r["rank"],
                                                            peaks, bound)


@pytest.mark.parametrize("arch", list(SPLIT_ARCHS))
def test_split_archs_prefill_and_serve(runs, arch):
    """The meshed prefill and two serve steps (the cache held with K/V
    heads and recurrent channels over "model"; the SSM's conv history
    whole for the step) against the unmeshed forward and decode: logits
    and the cache abs 1e-5; the prefill's FLOPs and collectives and a
    serve step's collectives equal to the dry run's."""
    item = runs["inputs"]["archs"][arch]
    model = tbuild(reduced(arch))
    params = params_from_numpy(item["params"], "cpu")
    prompt = torch.as_tensor(item["toks"][:, :PROMPT])
    enc = None if item["enc"] is None \
        else torch.as_tensor(item["enc"][:, :PROMPT])
    with torch.no_grad():
        # the meshed prefill's attention blocks: an encoder's padded keys
        # would take part in its non-causal attention
        want = [model.forward(params, prompt, enc_embeds=enc,
                              q_block=STEP["q_block"],
                              kv_block=STEP["kv_block"])[0].numpy()]
        _, cache = model.prefill(params, prompt, PROMPT + 8, enc_embeds=enc,
                                 cache_dtype=torch.float32)
        for t in range(2):
            lg, cache = model.decode_step(params, cache, torch.as_tensor(
                item["toks"][:, PROMPT + t:PROMPT + t + 1]))
            want.append(lg.numpy())
    got = runs["ranks"][0]["split_serving"][arch]
    for g, w in zip(got["logits"], want):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_ATOL)
    for k, v in host(cache).items():
        np.testing.assert_allclose(got["cache"][k], v, rtol=0,
                                   atol=LOGIT_ATOL, err_msg=k)
    prefill = dry(model, kind="prefill", seq=PROMPT,
                  param_dtype=torch.float32)
    decode = dry(model, kind="decode", seq=PROMPT, param_dtype=torch.float32)
    for r in runs["ranks"]:
        run = r["split_serving"][arch]
        assert run["prefill"]["flops"] == prefill["flops"]["total"]
        assert run["prefill"]["collectives"] == prefill["collectives"]
        assert run["decode_collectives"] == decode["collectives"]
    # a rank holds its rows and its half of the split caches' heads or
    # channels (the SSM's conv history on its stored chunk of x | B | C)
    shapes, full = got["local_shapes"], host(cache)
    split = [k for k in full if k.endswith(("/state", "/h", "/conv", "/xk",
                                            "/xv"))]
    assert split
    for name in split:
        assert 4 * np.prod(shapes[name]) == full[name].size, name


def test_ssm_head_split_reads_its_heads_and_every_b_c():
    """The SSM split by heads over two model ranks: rank k's z, x and dt
    columns of in_proj's output are its heads', B and C whole on both;
    its conv channels its heads' x, then B and C. The stored in_proj
    chunk (contiguous over z | x | B | C | dt) does not line up with the
    heads, hence the all-gather."""
    from repro_torch.nn import ssm as SSM

    model = tbuild(reduced("mamba2-1.3b"))
    sd = model.cfg.ssm_dims()
    di, gn, h, p = sd.d_inner, sd.d_state, sd.n_heads, sd.head_dim
    io = 2 * di + 2 * gn + h
    z, conv = torch.arange(io), torch.arange(sd.conv_dim)
    hl = h // 2
    for k in (0, 1):
        split = tsh.ModelSplit(("model",), None, k, 2, None)
        zg, x, b, c, dt = (v.tolist() for v in SSM._split_proj(z, sd, split))
        heads = list(range(k * hl * p, (k + 1) * hl * p))
        assert zg == heads
        assert x == [di + i for i in heads]
        assert b == list(range(2 * di, 2 * di + gn))
        assert c == list(range(2 * di + gn, 2 * di + 2 * gn))
        assert dt == list(range(2 * di + 2 * gn + k * hl,
                                2 * di + 2 * gn + (k + 1) * hl))
        assert SSM._conv_channels(conv, sd, split).tolist() \
            == heads + list(range(di, sd.conv_dim))
    s = tsh.make_param_shardings(model.spec, MESH)["blocks"]["g0"]["ssm"]
    stored = s["in_proj"].index((1, model.cfg.d_model, io),
                                {"data": 0, "model": 0})[2]
    assert (stored.start, stored.stop) == (0, io // 2) and io // 2 != di
    for key in ("a_log", "norm_scale", "out_proj"):
        assert tsh.kept_axes(tsh.make_param_shardings(model.spec, MESH),
                             ("blocks", "g0", "ssm", key),
                             tsh.DEFAULT_RULES) == ("model",), key
    for key in ("conv_w", "conv_b"):
        assert tsh.kept_axes(tsh.make_param_shardings(model.spec, MESH),
                             ("blocks", "g0", "ssm", key),
                             tsh.DEFAULT_RULES) == (), key
