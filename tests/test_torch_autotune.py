"""K2's configuration tuner (`repro_torch.kernels.lut_matmul.autotune`) on
the CPU, mirroring the JAX package's autotuner tests
(`tests/test_lut_fused.py`): the legal candidates and their shared memory
against the kernel's own reading on an H100, the model's picks at
olmo-1b's decode shapes and ResNet-20's serve shapes, the cache's round
trip with 0 retunes, ``measure`` over the model's top k and the untuned
configuration, the environment path, the fingerprints, the wrapper's
resolution before its device dispatch, and the serving engine's
``autotune_cache`` round trip (tokens equal with and without it, the file
written after warmup, a second engine with 0 retunes). The JAX package's
tuner ranks TPU block shapes: the one comparison with it is that its cache
is refused here.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.lut_matmul import autotune as at
from repro_torch.kernels.lut_matmul import lut_matmul as k2
from repro_torch.kernels.lut_matmul import ops, ref
from repro_torch.kernels.lut_matmul.lut_matmul import K2Config, x_width
from repro_torch.models.lm import build_lm
from repro_torch.nn.cnn import resnet20
from repro_torch.nn.spec import init_params
from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine
from repro_torch.serving.fleet import PlanHandle

F32, BF16 = torch.float32, torch.bfloat16

# dynamic shared memory a block, as `lut_matmul.config` read it off the
# kernel on an H100 80GB HBM3 (pre-pass at both X dtypes, in-tile dequant at
# float32)
CARD_SMEM = {
    (128, 16, "prepass", F32): 94208, (128, 16, "prepass", BF16): 61440,
    (128, 32, "prepass", F32): 110592, (128, 32, "prepass", BF16): 77824,
    (64, 64, "prepass", F32): 106496, (64, 64, "prepass", BF16): 90112,
    (32, 16, "prepass", F32): 38912, (32, 16, "prepass", BF16): 30720,
    (32, 32, "prepass", F32): 55296, (32, 32, "prepass", BF16): 47104,
    (32, 64, "prepass", F32): 88064, (32, 64, "prepass", BF16): 79872,
    (16, 16, "prepass", F32): 29696, (16, 16, "prepass", BF16): 25600,
    (16, 32, "prepass", F32): 46080, (16, 32, "prepass", BF16): 41984,
    (16, 64, "prepass", F32): 78848, (16, 64, "prepass", BF16): 74752,
    (128, 16, "tile", F32): 77824, (128, 32, "tile", F32): 79872,
    (64, 64, "tile", F32): 47104, (32, 16, "tile", F32): 22528,
    (32, 32, "tile", F32): 24576, (32, 64, "tile", F32): 28672,
    (16, 16, "tile", F32): 13312, (16, 32, "tile", F32): 15360,
    (16, 64, "tile", F32): 19456,
}


def olmo_decode_shapes(m=4):
    """(M, K_x, N) of olmo-1b's seven units at a decode step of 4 rows (or
    another M)."""
    cfg = get_config("olmo-1b")
    d, f = cfg.d_model, cfg.d_ff
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    return [(m, k, n) for k, n in ((d, d), (d, kv), (d, kv), (d, d), (d, f),
                                   (d, f), (f, d))]


def resnet20_serve_shapes():
    """(M, K_x, N) of ResNet-20's serve pass at batch 256, rows as the serve
    path feeds them (K rounded up to 8)."""
    return sorted({(256 * cl.out_hw[0] * cl.out_hw[1],
                    x_width(cl.c_in * cl.kernel * cl.kernel), cl.c_out)
                   for cl in resnet20().comp_layers})


@pytest.fixture
def fresh_default():
    at.reset_default_autotuner()
    yield
    at.reset_default_autotuner()


# ------------------------------------------------------------ candidates


@pytest.mark.parametrize("key", sorted(CARD_SMEM, key=str),
                         ids=lambda k: f"{k[0]}x{k[1]}/{k[2]}/"
                         f"{str(k[3]).replace('torch.', '')}")
def test_smem_formula_matches_the_kernels_reading(key):
    bm, bn, dq, dtype = key
    assert K2Config(bm, bn, dq).smem_bytes(dtype) == CARD_SMEM[key]


@pytest.mark.parametrize("m,k,n,dtype", [(4, 2048, 2048, F32),
                                         (32, 4096, 6400, BF16),
                                         (33, 200, 70, F32),
                                         (262144, 144, 16, F32),
                                         (256, 64, 10, BF16)])
def test_candidate_blocks_are_legal(m, k, n, dtype):
    cands = at.candidate_blocks(m, k, n, dtype)
    budget = at.MachineBalance().smem_per_block
    assert cands and len(set(cands)) == len(cands)
    for c in cands:
        assert c.smem_bytes(dtype) <= budget
        assert c.block_m > at.SMALL_M or m <= at.SMALL_M
        assert c.dequant == "prepass" or n % 16 == 0
    # every table tile for the problem, each dequant mode where legal
    want = {(bm, bn) for bm, bn in k2.TILES if bm > at.SMALL_M or m <= 32}
    assert {(c.block_m, c.block_n) for c in cands} == want
    assert any(c.dequant == "tile" for c in cands) == (n % 16 == 0)
    # a budget that a tile's rings do not fit drops it
    small = at.MachineBalance(smem_per_block=60_000)
    assert [c for c in cands if c.smem_bytes(dtype) <= 60_000] \
        == at.candidate_blocks(m, k, n, dtype, balance=small)


def test_config_table_and_default_choice():
    assert k2.default_config(10) == K2Config(128, 16)
    assert k2.default_config(32) == K2Config(128, 32)
    assert k2.default_config(4096) == K2Config(64, 64, "prepass")
    with pytest.raises(ValueError, match="table"):
        K2Config(64, 16)
    with pytest.raises(ValueError, match="dequant"):
        K2Config(16, 16, "split-k")
    assert k2.tile_dequant_legal(2048, 128)
    assert not k2.tile_dequant_legal(10, 128)
    assert not k2.tile_dequant_legal(2048, 32)
    c = K2Config(16, 64, "tile")
    assert c.threads == 256 and K2Config.from_json(c.to_json()) == c
    assert str(c) == "16x64/tile"


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("m,k,n", olmo_decode_shapes())
def test_model_picks_in_tile_dequant_and_a_small_tile_at_olmo_decode(m, k, n):
    best = min(at.candidate_blocks(m, k, n),
               key=lambda c: at.roofline_time(m, k, n, c))
    assert best.dequant == "tile" and best.block_m == 16
    untuned = k2.default_config(n)
    assert at.roofline_time(m, k, n, best) \
        < at.roofline_time(m, k, n, untuned)


@pytest.mark.parametrize("m,k,n", resnet20_serve_shapes())
def test_model_picks_the_prepass_at_resnet20_serve_shapes(m, k, n):
    """At batch 256 the in-GEMM dequant would repeat over hundreds of tile
    rows: the pre-pass, a large tile."""
    best = min(at.candidate_blocks(m, k, n),
               key=lambda c: at.roofline_time(m, k, n, c))
    assert best.dequant == "prepass" and best.block_m >= 64


@pytest.mark.parametrize("m,k,n", olmo_decode_shapes(4 * 256))
def test_model_keeps_the_untuned_config_at_olmo_prefill(m, k, n):
    """At a prefill of 4 x 256 rows the model ties the 128x32 and 64x64
    pre-pass tiles; the tie keeps the kernel's own choice, which the card
    does not beat by more than its spread."""
    assert at.BlockAutotuner().best(m, k, k, n) == k2.default_config(n)


# ------------------------------------------------------------------ cache


def test_autotuner_cache_roundtrip_zero_retunes(tmp_path):
    path = str(tmp_path / "cache.json")
    problems = [dict(m=4, k_x=2048, k_pad=2048, n=8192),
                dict(m=16384, k_x=288, k_pad=384, n=64, x_dtype=BF16)]
    t1 = at.BlockAutotuner(path=path)
    winners = [t1.best(**p) for p in problems]
    assert t1.stats()["retune_events"] == len(problems)
    assert t1.best(**problems[0]) == winners[0]       # a hit, no retune
    assert t1.stats()["retune_events"] == len(problems)
    t1.save()
    payload = json.loads((tmp_path / "cache.json").read_text())
    assert payload["version"] == 1 and len(payload["entries"]) == 2

    t2 = at.BlockAutotuner(path=path)                 # loads at construction
    assert [t2.best(**p) for p in problems] == winners
    st = t2.stats()
    assert st["retune_events"] == 0 and st["hits"] == len(problems)
    t2.clear()
    assert t2.stats()["entries"] == 0


def test_measure_refines_top_k_and_the_untuned_config():
    calls = []

    def measure(cfg):
        calls.append(cfg)
        return 0.5 if cfg == k2.default_config(2048) else 1.0 + len(calls)

    t = at.BlockAutotuner()
    best = t.best(4, 2048, 2048, 2048, measure=measure, top_k=2)
    ranked = sorted(at.candidate_blocks(4, 2048, 2048),
                    key=lambda c: at.roofline_time(4, 2048, 2048, c))
    assert calls == ranked[:2] + [k2.default_config(2048)]
    assert best == k2.default_config(2048)            # the fastest measured
    (entry,) = t.entries().values()
    assert entry["source"] == "measured" and len(entry["measured_s"]) == 3


def test_default_autotuner_honors_env_cache(tmp_path, monkeypatch,
                                            fresh_default):
    path = str(tmp_path / "env_cache.json")
    t = at.BlockAutotuner(path=path)
    t.best(8, 256, 256, 128)
    t.save()
    monkeypatch.setenv(at.ENV_CACHE_PATH, path)
    at.reset_default_autotuner()
    d = at.get_default_autotuner()
    assert d is at.get_default_autotuner()
    d.best(8, 256, 256, 128)
    assert d.stats() == {**d.stats(), "retune_events": 0, "hits": 1}
    assert at.ENV_CACHE_PATH == "REPRO_TORCH_LUT_AUTOTUNE_CACHE"


def test_fingerprint_separates_shapes_dtypes_and_devices():
    fp = at.shape_fingerprint
    base = dict(pack_block=128, x_dtype=F32, device="cpu")
    ref_fp = fp(4, 2048, 2048, 2048, **base)
    assert ref_fp == fp(4, 2048, 2048, 2048, **base)
    assert ref_fp != fp(8, 2048, 2048, 2048, **base)
    assert ref_fp != fp(4, 2040, 2048, 2048, **base)          # K_x
    assert ref_fp != fp(4, 2048, 2176, 2048, **base)          # K_pad
    assert ref_fp != fp(4, 2048, 2048, 2048, **{**base, "pack_block": 64})
    assert ref_fp != fp(4, 2048, 2048, 2048, **{**base, "x_dtype": BF16})
    assert ref_fp != fp(4, 2048, 2048, 2048,
                        **{**base, "device": "NVIDIA H100 80GB HBM3"})
    assert at.device_name("cpu") == "cpu"


def test_load_refuses_other_versions_and_the_jax_packages_cache(tmp_path):
    from repro.kernels.lut_matmul import autotune as jat

    jax_cache = tmp_path / "jax.json"
    jt = jat.BlockAutotuner(path=str(jax_cache))
    jt.best(8, 512, 256, backend="cpu")
    jt.save()
    with pytest.raises(ValueError, match="TPU block shapes"):
        at.BlockAutotuner(path=str(jax_cache))
    bad = tmp_path / "v2.json"
    bad.write_text(json.dumps({"version": 2, "entries": {}}))
    with pytest.raises(ValueError, match="version"):
        at.BlockAutotuner().load(str(bad))
    assert at.ENV_CACHE_PATH != jat.ENV_CACHE_PATH


# ------------------------------------------------------- the fused wrapper


def _case(m, k, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((k, n), generator=gen) * 0.05
    packed, cb, scale = ops.compress_layer_weights(w, range(-7, 9),
                                                   block_k=128)
    return torch.randn((m, k), generator=gen), packed, cb, scale


def test_fused_call_resolves_through_the_default_tuner(fresh_default):
    x, packed, cb, scale = _case(4, 256, 64)
    tuner = at.get_default_autotuner()
    y = ops.lut_matmul_fused(x, packed, cb, scale)
    assert tuner.stats()["misses"] == 1
    (entry,) = tuner.entries().values()
    assert entry["shape"] == [4, 256, 256, 64, 128]
    assert entry["device"] == "cpu" and entry["x_dtype"] == "float32"
    ops.lut_matmul_fused(x, packed, cb, scale)
    assert tuner.stats()["hits"] == 1
    # an explicit configuration leaves the tuner alone; the plain version
    # gives the same result whatever the configuration
    for cfg in at.candidate_blocks(4, 256, 64):
        assert torch.equal(ops.lut_matmul_fused(x, packed, cb, scale,
                                                config=cfg), y)
    assert tuner.stats()["hits"] + tuner.stats()["misses"] == 2
    assert torch.equal(y, ref.lut_matmul_fused_ref(x, packed, cb, scale))
    # the checks run before the tuner is asked
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.lut_matmul_fused(x[:, :250], packed, cb, scale)
    assert tuner.stats()["entries"] == 1


def test_the_kernels_launcher_refuses_cpu_tensors():
    x, packed, cb, scale = _case(4, 256, 64)
    with pytest.raises(ValueError, match="CUDA"):
        k2.launch(x, packed, cb, scale, config=K2Config(16, 16, "tile"))


# -------------------------------------------------- the engine's cache


@pytest.fixture(scope="module")
def tiny_lm():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = get_config("olmo-1b").scaled_down(compute_dtype="float32")
    model = build_lm(cfg)
    yield model, init_params(0, model.spec, "cpu")
    torch.set_num_threads(n)


def test_engine_autotune_cache_round_trip(tiny_lm, tmp_path, fresh_default):
    """The LUT engine with ``autotune_cache``: tokens equal the engine's
    without it, the cache is written after warmup, and a second engine on
    a fresh process-wide tuner resolves every shape from it: 0 retunes."""
    model, params = tiny_lm
    plan = PlanHandle.from_compress_k(model, 8, device="cpu")
    cache = tmp_path / "autotune.json"
    base = dict(max_batch=2, prompt_buckets=(8,), new_token_buckets=(8,),
                max_waves=1, lut_serve=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, size=6).astype(np.int32)
               for _ in range(2)]

    def run(config):
        eng = ServingEngine(model, params, mode="oneshot", config=config,
                            plan=plan, device="cpu")
        eng.warmup([(6, 4)])
        written = cache.exists()
        out = eng.serve([ServeRequest(tokens=p, max_new_tokens=4)
                         for p in prompts])
        return eng, [r.tokens for r in out], written

    eng0, toks0, _ = run(EngineConfig(**base))
    assert eng0.serve_units > 0 and not cache.exists()
    at.reset_default_autotuner()
    cfg = EngineConfig(**base, autotune_cache=str(cache))
    _, toks1, written = run(cfg)
    assert toks1 == toks0
    assert written                                    # saved by warmup
    first = at.get_default_autotuner().stats()
    assert first["retune_events"] == first["entries"] > 0

    at.reset_default_autotuner()                      # a warm restart
    _, toks2, _ = run(cfg)
    assert toks2 == toks0
    st = at.get_default_autotuner().stats()
    assert st["retune_events"] == 0 and st["hits"] > 0
    assert st["entries"] == first["entries"]
    assert dataclasses.replace(cfg).autotune_cache == str(cache)
