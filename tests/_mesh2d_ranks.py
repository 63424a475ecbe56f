"""Rank side of `tests/test_torch_mesh2d.py`: what each of the four gloo
processes of the 2 x 2 ("data", "model") CPU mesh runs (torch and the port
only; importable by name from a spawned process)."""

import numpy as np
import torch

# the storage-only layout: no unit splits its compute over "model"
STORAGE_ONLY = dict(heads=None, mlp=None, vocab=None, kv_heads=None)
# tensor-parallel experts: every expert on every model rank, at its chunk
# of the hidden width (the default rules split the experts themselves)
TP_EXPERTS = dict(expert=None, moe_ff="model")
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
# the MoE layouts whose prefill and serve steps the ranks run
MOE_LAYOUTS = {"experts": {}, "tp_experts": TP_EXPERTS}
# the recurrent mixers and the encoder-decoder, split over "model": arch ->
# `scaled_down` overrides (recurrentgemma at one (rglru, rglru, local)
# repeat)
SPLIT_ARCHS = {"mamba2-1.3b": {}, "recurrentgemma-2b": {"n_layers": 3},
               "whisper-large-v3": {}}
ENC_LEN = 32        # whisper's stub frames: a multiple of the key block
PROMPT = 16         # the split archs' served prompt (and whisper's frames)


def reduced(arch):
    """The reduced float32 config of ``arch`` the mesh tests run."""
    from repro_torch.configs import get_config

    return get_config(arch).scaled_down(compute_dtype="float32",
                                        **SPLIT_ARCHS.get(arch, {}))


class ActCodes:
    """Patches `qat.fake_quant_act` while open and records each call's int8
    codes (numpy); the value returned is the function's own."""

    def __init__(self):
        self.codes = []

    def __enter__(self):
        from repro_torch.core import qat

        self._real = qat.fake_quant_act

        def fake_quant_act(a, cand_dim=None, *, token_dims=0):
            scale = qat._act_scale(a, cand_dim, token_dims)
            codes = qat._round_clip(a / scale)
            self.codes.append(codes.detach().to(torch.int8).numpy())
            return a + (codes * scale - a).detach()

        qat.fake_quant_act = fake_quant_act
        return self

    def __exit__(self, *exc):
        from repro_torch.core import qat

        qat.fake_quant_act = self._real


class ReplayCodes:
    """Patches `qat.fake_quant_act` while open so that call i rounds to
    ``codes[i]`` (the unmeshed step's int8 codes, e.g. the JAX package's)
    instead of its own: this rank's rows (the data coordinate's chunk of
    dim 0) and, on features split over "model", its model chunk of the
    first axis whose length differs; the scale is the call's own."""

    def __init__(self, codes, coords):
        self.codes, self.coords, self.calls = codes, coords, 0

    def __enter__(self):
        from repro_torch.core import qat

        self._real = qat.fake_quant_act

        def fake_quant_act(a, cand_dim=None, *, token_dims=0):
            scale = qat._act_scale(a, cand_dim, token_dims)
            want = torch.from_numpy(np.array(self.codes[self.calls]))
            self.calls += 1
            for ax, coord in ((0, "data"), (None, "model")):
                if ax is None:
                    ax = next((i for i in range(1, a.ndim)
                               if a.shape[i] != want.shape[i]), None)
                if ax is not None and a.shape[ax] != want.shape[ax]:
                    n = a.shape[ax]
                    want = want.narrow(ax, self.coords[coord] * n, n)
            return a + (want.to(a.dtype) * scale - a).detach()

        qat.fake_quant_act = fake_quant_act
        return self

    def __exit__(self, *exc):
        from repro_torch.core import qat

        qat.fake_quant_act = self._real


def wait_for_codes(path, deadline_s=240.0):
    """{arch: [codes]} from the file the test process writes (``np.savez``
    keys ``arch|i``) once it has them; raises if the writer failed."""
    import os
    import time

    end = time.monotonic() + deadline_s
    while not os.path.exists(path):
        if os.path.exists(path + ".failed"):
            raise RuntimeError(open(path + ".failed").read())
        if time.monotonic() > end:
            raise TimeoutError(f"no activation codes at {path}")
        time.sleep(0.2)
    out: dict = {}
    with np.load(path) as z:
        for key in sorted(z.files, key=lambda k: int(k.split("|")[1])):
            out.setdefault(key.split("|")[0], []).append(z[key])
    return out


def host(tree):
    from repro_torch.nn.spec import flatten_with_names

    return {k: v.detach().cpu().numpy()
            for k, v in flatten_with_names(tree).items()}


def _batch(toks, enc=None):
    out = {"tokens": torch.as_tensor(toks[:, :-1]),
           "labels": torch.as_tensor(toks[:, 1:])}
    if enc is not None:
        out["enc_embeds"] = torch.as_tensor(enc[:len(toks)])
    return out


def _train(model, cfg, mesh, params, comp, toks, *, steps, dispatch=False,
           rules=None, enc=None, replay=None):
    """``steps`` meshed train steps from the full numpy state: (losses, the
    gathered state after step 1 and after the last, this rank's codes, each
    step's peak of gathered bytes, the first step's matmul FLOPs counted by
    `FlopCounterMode` and its collectives). ``replay``: the unmeshed
    step's activation codes, which the meshed step rounds to
    (`ReplayCodes`)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T
    from repro_torch.nn.spec import params_from_numpy

    rules = S.DEFAULT_RULES if rules is None else rules
    p = params_from_numpy(params, "cpu")
    c = params_from_numpy(comp, "cpu")
    sh = T.train_state_shardings(model, mesh, rules)
    state = S.shard_tree({"params": p, "opt": T.make_optimizer(cfg).init(p)},
                         sh)
    local_comp = S.shard_tree(c, T.comp_shardings(model, mesh, rules))
    step = T.make_train_step(model, cfg, mesh=mesh, rules=rules,
                             moe_local_dispatch=dispatch)
    losses, firsts, peaks, counted = [], None, [], {}
    with ActCodes() if replay is None \
            else ReplayCodes(replay, mesh.coords) as rec:
        for i in range(steps):
            S.reset_collective_counts()
            with FlopCounterMode(display=False) as flops:
                state, met = step(state, _batch(toks, enc), local_comp)
            if i == 0:
                counted = {"flops": flops.get_total_flops(),
                           "collectives": S.collective_counts()}
            peaks.append(int(met.pop("gathered_peak_bytes")))
            losses.append({k: float(v) for k, v in met.items()})
            if i == 0:
                firsts = host(S.gather_tree(state, sh))
    return (losses, firsts, host(S.gather_tree(state, sh)),
            getattr(rec, "codes", None), peaks, counted)


def gather_backward_checks(mesh):
    """`gather_at_use`'s forward and backward on this rank, for leaves of
    several layouts, the batch split over "data": the full tensor, and the
    slice's gradient against the slice of the two data rows' summed
    gradients."""
    from repro_torch.distributed import sharding as S

    def grad_of(data, shape):
        return torch.from_numpy(np.random.default_rng(
            [data, *shape]).standard_normal(shape).astype(np.float32))

    out = {}
    specs = {"data x model": ((8, 6), ("data", "model")),
             "model": ((8, 6), (None, "model")),
             "data": ((6, 8), (None, "data")),
             "replicated": ((4, 3), ()),
             "data+model": ((8,), (("data", "model"),))}
    full_ok = True
    for name, (shape, spec) in specs.items():
        s = S.NamedSharding(mesh, S.PartitionSpec(*spec))
        full = torch.arange(np.prod(shape), dtype=torch.float32) \
            .reshape(shape)
        x = s.local(full).clone().requires_grad_(True)
        y = S.gather_at_use(x, s, ("data",))
        full_ok &= bool(torch.equal(y, full))
        (y * grad_of(mesh.coords["data"], shape)).sum().backward()
        want = s.local(grad_of(0, shape) + grad_of(1, shape))
        out[name] = bool(torch.equal(x.grad, want))
    out["forward gathers the full tensor"] = full_ok
    return out


def moe_serving(mesh, cfg, item, rank):
    """phi3.5-moe's meshed prefill and two serve steps on each MoE layout
    (the cache held with K/V heads over "model"): the logits put together
    (rank 0), the prefill's FLOPs and collectives, the first serve step's
    collectives."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import Shape, get_config
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T
    from repro_torch.models.lm import build_lm
    from repro_torch.nn.spec import params_from_numpy

    model = build_lm(get_config(MOE_ARCH).scaled_down(
        compute_dtype="float32"))
    vocab = model.cfg.padded_vocab
    params = params_from_numpy(item["params"], "cpu")
    prompt = torch.as_tensor(item["toks"][:, :16])
    with torch.no_grad():
        _, cache = model.prefill(params, prompt, 24,
                                 cache_dtype=torch.float32)
    out = {}
    for name, layout in MOE_LAYOUTS.items():
        rules = S.DEFAULT_RULES.replace(**layout) if layout \
            else S.DEFAULT_RULES
        local_params = S.shard_tree(params, S.make_param_shardings(
            model.spec, mesh, rules))
        S.reset_collective_counts()
        with FlopCounterMode(display=False) as flops:
            block = T.make_prefill_step(model, cfg, mesh=mesh, rules=rules)(
                local_params, {"tokens": prompt})
        run = {"prefill": {"flops": flops.get_total_flops(),
                           "collectives": S.collective_counts()},
               "logits": [S.gather(block, S.logits_sharding(
                   mesh, (4, 16, vocab), rules)).numpy()]}
        c_sh = T.cache_shardings(model, Shape("d", "decode", 24, 4), mesh,
                                 rules, dtype=torch.float32)
        step = T.make_serve_step(model, cfg, mesh=mesh, rules=rules,
                                 cache_shardings=c_sh)
        local = S.shard_tree(cache, c_sh)
        for t in range(2):
            S.reset_collective_counts()
            lg, local = step(local_params, local, torch.as_tensor(
                item["toks"][:, 16 + t:17 + t]))
            run.setdefault("decode_collectives", S.collective_counts())
            run["logits"].append(S.gather(lg, S.logits_sharding(
                mesh, (4, 1, vocab), rules)).numpy())
        if rank:
            run.pop("logits")
        out[name] = run
    return out


def split_serving(mesh, cfg, arch, item, rank):
    """A split arch's meshed prefill and two serve steps (the cache held
    on `cache_shardings`: K/V heads and recurrent channels over "model",
    from the unmeshed prefill's cache): the logits put together (rank 0),
    the prefill's FLOPs and collectives, the first serve step's
    collectives, the gathered peaks."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import Shape
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T
    from repro_torch.models.lm import build_lm
    from repro_torch.nn.spec import params_from_numpy

    model = build_lm(reduced(arch))
    vocab = model.cfg.padded_vocab
    params = params_from_numpy(item["params"], "cpu")
    prompt = {"tokens": torch.as_tensor(item["toks"][:, :PROMPT])}
    if item.get("enc") is not None:
        prompt["enc_embeds"] = torch.as_tensor(item["enc"][:, :PROMPT])
    with torch.no_grad():
        _, cache = model.prefill(params, prompt["tokens"], PROMPT + 8,
                                 enc_embeds=prompt.get("enc_embeds"),
                                 cache_dtype=torch.float32)
    local_params = S.shard_tree(params, S.make_param_shardings(
        model.spec, mesh))
    S.reset_collective_counts()
    with FlopCounterMode(display=False) as flops:
        block = T.make_prefill_step(model, cfg, mesh=mesh)(local_params,
                                                           prompt)
    run = {"prefill": {"flops": flops.get_total_flops(),
                       "collectives": S.collective_counts()},
           "peaks": [S.gathered_bytes()["peak"]],
           "logits": [S.gather(block, S.logits_sharding(
               mesh, (4, PROMPT, vocab))).numpy()]}
    # a decode cell of the prompt's rows (whisper's: its frames); the
    # layout does not depend on the cache's length
    c_sh = T.cache_shardings(model, Shape("d", "decode", PROMPT, 4), mesh,
                             dtype=torch.float32)
    step = T.make_serve_step(model, cfg, mesh=mesh, cache_shardings=c_sh)
    local = S.shard_tree(cache, c_sh)
    run["local_shapes"] = {k: tuple(v.shape)
                           for k, v in host(local).items()}
    for t in range(2):
        S.reset_collective_counts()
        lg, local = step(local_params, local, torch.as_tensor(
            item["toks"][:, PROMPT + t:PROMPT + t + 1]))
        run.setdefault("decode_collectives", S.collective_counts())
        run["peaks"].append(S.gathered_bytes()["peak"])
        run["logits"].append(S.gather(lg, S.logits_sharding(
            mesh, (4, 1, vocab))).numpy())
    run["cache"] = host(S.gather_tree(local, c_sh))
    if rank:
        run.pop("logits")
        run.pop("cache")
    return run


def rank_checks(rank, world, inputs, ckpt_dir):
    """Every check of the 2 x 2 mesh in one process group."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import Shape, get_config
    from repro_torch.distributed import elastic
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T
    from repro_torch.models.lm import build_lm
    from repro_torch.nn.spec import params_from_numpy

    mesh = S.process_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = {"rank": rank, "coords": mesh.coords}

    # DTensor's slices == the port's == (tests) JAX's device order
    full = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    dt = {}
    for spec in ((("data", "model"),), (None, "data", "model"),
                 ("model", None, "data"), ("data",)):
        s = S.NamedSharding(mesh, S.PartitionSpec(*spec))
        mine = distribute_tensor(full, mesh.device_mesh,
                                 list(s.placements)).to_local()
        dt[repr(spec)] = bool(torch.equal(mine, s.local(full)))
        back = S.gather(s.local(full).clone(), s)
        dt[repr(spec) + " gather"] = bool(torch.equal(back, full))
    out["dtensor"] = dt
    out["rows_of_shard0_shard0"] = S.NamedSharding(
        mesh, S.PartitionSpec(("data", "model"))).local(full)[:, 0, 0] \
        .tolist()

    cfg = T.StepConfig(**inputs["step_cfg"])
    trained = None
    for name, (arch, layout) in inputs["runs"].items():
        item = inputs["archs"][arch]
        model = build_lm(reduced(arch))
        losses, first, last, codes, peaks, counted = _train(
            model, cfg, mesh, item["params"], item["comp"], item["toks"],
            steps=2, dispatch=item["dispatch"],
            rules=S.DEFAULT_RULES.replace(**layout) if layout else None,
            enc=item.get("enc"))
        trained = last if name == "olmo-1b" else trained
        out[name] = {"losses": losses, "first": first if rank == 0 else None,
                     "last": last if rank == 0 else None,
                     "codes": codes, "gathered_peaks": peaks,
                     "counted": counted}
    # the split archs on the JAX package's own activation rounding (its
    # codes, recorded without remat, replayed), for the comparison with it
    replay_cfg = T.StepConfig(**dict(inputs["step_cfg"], remat=False))
    for arch, codes in wait_for_codes(inputs["jax_codes_file"]).items():
        item = inputs["archs"][arch]
        losses, first, last, *_ = _train(
            build_lm(reduced(arch)), replay_cfg, mesh, item["params"],
            item["comp"], item["toks"], steps=2, enc=item.get("enc"),
            replay=codes)
        out[f"{arch}-jax-rounding"] = {
            "losses": losses, "first": first if rank == 0 else None,
            "last": last if rank == 0 else None}
    out["gather_backward"] = gather_backward_checks(mesh)

    olmo = inputs["archs"]["olmo-1b"]
    model = build_lm(get_config("olmo-1b").scaled_down(
        compute_dtype="float32"))
    # a batch of 3 rows does not divide the data axis: it replicates
    rep = _train(model, cfg, mesh, olmo["params"], olmo["comp"],
                 olmo["toks"][:3], steps=1)
    out["replicated"] = {"losses": rep[0],
                         "last": rep[2] if rank == 0 else None,
                         "gathered_peaks": rep[4]}
    # other layouts of the same step: storage only (every unit computed
    # whole, as before tensor parallelism), and K/V heads replicated while
    # the query heads split (each rank computes the K/V heads its heads read)
    for name, kw in (("storage_only", STORAGE_ONLY),
                     ("kv_replicated", dict(kv_heads=None))):
        run = _train(model, cfg, mesh, olmo["params"], olmo["comp"],
                     olmo["toks"], steps=1, rules=S.DEFAULT_RULES.replace(
                         **kw))
        out[name] = {"losses": run[0], "last": run[2] if rank == 0 else None,
                     "gathered_peaks": run[4], "counted": run[5]}

    # prefill and decode over the mesh
    params = params_from_numpy(olmo["params"], "cpu")
    p_sh = S.make_param_shardings(model.spec, mesh)
    local_params = S.shard_tree(params, p_sh)
    prompt = torch.as_tensor(olmo["toks"][:, :16])
    S.reset_collective_counts()
    logits_block = T.make_prefill_step(model, cfg, mesh=mesh)(
        local_params, {"tokens": prompt})
    out["prefill_collectives"] = S.collective_counts()
    out["prefill_gathered_peak"] = S.gathered_bytes()["peak"]
    out["prefill_block"] = tuple(logits_block.shape)
    logits = S.gather(logits_block, S.logits_sharding(
        mesh, (4, 16, model.cfg.padded_vocab)))
    max_len = 24
    with torch.no_grad():
        _, cache = model.prefill(params, prompt, max_len,
                                 cache_dtype=torch.float32)
    c_sh = T.cache_shardings(model, Shape("d", "decode", max_len, 4), mesh,
                             dtype=torch.float32)
    served = {}
    for name, shardings in (("heads", c_sh), ("rows", None)):
        step = T.make_serve_step(model, cfg, mesh=mesh,
                                 cache_shardings=shardings)
        rows_sh = T.cache_shardings(
            model, Shape("d", "decode", max_len, 4), mesh,
            rules=S.ShardingRules((("batch", ("pod", "data")),)),
            dtype=torch.float32)
        store = rows_sh if shardings is None else shardings
        local = S.shard_tree(cache, store)
        outs = []
        for t in range(2):
            tok = torch.as_tensor(olmo["toks"][:, 16 + t:17 + t])
            lg, local = step(local_params, local, tok)
            out.setdefault("serve_gathered_peaks", []).append(
                S.gathered_bytes()["peak"])
            outs.append(S.gather(lg, S.logits_sharding(
                mesh, (4, 1, model.cfg.padded_vocab))))
        served[name] = {"logits": [o.numpy() for o in outs],
                        "cache": host(S.gather_tree(local, store)),
                        "local_k": tuple(local["groups"]["g0"]["k"].shape)}
    out["prefill_logits"] = logits.numpy() if rank == 0 else None
    out["served"] = served if rank == 0 else {
        k: {"local_k": v["local_k"]} for k, v in served.items()}
    out["moe_serving"] = moe_serving(mesh, cfg, inputs["archs"][MOE_ARCH],
                                     rank)
    out["split_serving"] = {arch: split_serving(mesh, cfg, arch,
                                                inputs["archs"][arch], rank)
                            for arch in SPLIT_ARCHS}

    # a checkpoint saved under 2 x 2, restored onto 4 x 1 and 1 x 4
    from repro_torch.checkpoint.manager import _unflatten

    state = S.shard_tree(params_from_numpy(_unflatten(trained), "cpu"),
                         T.train_state_shardings(model, mesh))
    whole = S.gather_tree(state, T.train_state_shardings(model, mesh))
    ckpt = CheckpointManager(ckpt_dir, async_save=False)
    if rank == 0:
        ckpt.save(3, whole, block=True)
    dist.barrier()
    restored = {}
    for shape in ((4, 1), (1, 4)):
        mesh2 = elastic.available_mesh(shape[1])
        step_n, st = elastic.elastic_restore(ckpt, model, mesh2)
        sh2 = T.train_state_shardings(model, mesh2)
        got = host(S.gather_tree(st, sh2))
        want = host(whole)
        local_ok = all(S.tree_leaves(S.tree_map(
            lambda v, s, w: tuple(v.shape) == s.shard_shape(w.shape),
            st, sh2, whole)))
        restored["x".join(map(str, shape))] = {
            "step": step_n, "mesh": mesh2.shape, "local_shapes": local_ok,
            "equal": all(np.array_equal(got[k], want[k]) for k in want),
            "sharded_leaves": sum(
                1 for s in S.tree_leaves(sh2) if any(e is not None
                                                     for e in s.spec))}
    out["restored"] = restored
    return out
