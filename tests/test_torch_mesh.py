"""The port's 1-D device meshes (`repro_torch.distributed.sharding`) on CPU
meshes, against the port's unsharded paths and against the JAX package's
meshes (in process, on its one CPU device): the sharded tile batch of the
profiler, the runner's ``profile_mesh`` and ``sweep_mesh``, and the serving
engine's and the fleet's request mesh.

A CPU mesh repeats the one CPU device (``["cpu"] * n``): its shards run one
after another, which checks the split, the padding and the reduction of a
mesh of n shards without n devices.

Tolerances and why:
  * the port's sharded paths against its unsharded ones: exact, floats
    included. The profiler sums the shards' int64 statistics before pricing
    them once; a candidate's or a request row's arithmetic does not depend
    on how many candidates or rows share its call (float64 sums rounded
    once, ``QuantConfig.batch_invariant`` in the engine).
  * ``sharded_layer_stats`` against JAX's on the same tiles: the count and
    the two histograms exact (integers), ``energy_sum`` rtol 1e-5 (JAX sums
    float32 energies tile by tile, the port prices the integer sums once in
    float64).
  * the sharded sweep against JAX's ``CnnRunner(sweep_mesh=sweep_mesh())``
    on the same numpy batches and initial parameters: one step's losses rel
    1e-5 (test_torch_qat_train.py's one-step bound) and each candidate's
    parameters after it whole-tree rel-L2 1e-3 (its bound for one QAT step
    of LeNet-5 from a shared state: AdamW's first step turns a float32
    round-off in a near-zero gradient into a full ``lr`` step; measured
    6.9e-4); the accuracies exact (test_torch_schedule.py's bound),
    evaluated on JAX's trained parameters.
  * the engine's and the fleet's greedy tokens against JAX's engine on the
    uncompressed plan with exact-fit prompts: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.profiler import batched_layer_stats as j_batched_stats
from repro.core.profiler import sharded_layer_stats as j_sharded_stats
from repro.core.runner import CnnRunner as JRunner
from repro.distributed.sharding import request_mesh as j_request_mesh
from repro.distributed.sharding import sweep_mesh as j_sweep_mesh
from repro.distributed.sharding import tile_mesh as j_tile_mesh
from repro.models.lm import build_lm as jbuild
from repro.nn import cnn as jcnn
from repro.nn.spec import init_params as jinit
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeRequest as JServeRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch._device import tree_leaves
from repro_torch.configs import get_config as tget
from repro_torch.core import qat as tqat
from repro_torch.core.profiler import batched_layer_stats, profile_layer
from repro_torch.core.profiler import sharded_layer_stats
from repro_torch.core.runner import CnnRunner
from repro_torch.distributed import (
    LocalMesh,
    request_mesh,
    sweep_mesh,
    tile_mesh,
)
from repro_torch.distributed.sharding import split_leading, to_device
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn import cnn as tcnn
from repro_torch.nn.spec import params_from_numpy
from repro_torch.serving import (
    EngineConfig,
    FleetRouter,
    PlanHandle,
    RouterConfig,
    ServeRequest,
    ServingEngine,
)

_SPLIT = {"train": 0, "val": 1, "test": 2}
BATCH = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work in this file runs on one thread: beside the
    suite's parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(make, n):
    return make(["cpu"] * n)


def j2t(tree):
    return params_from_numpy(jax.device_get(tree), "cpu")


def rel_l2(a, b):
    a = np.concatenate([np.asarray(x, np.float64).ravel() for x in a])
    b = np.concatenate([np.asarray(x, np.float64).ravel() for x in b])
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


# ------------------------------------------------------------------- mesh


def test_mesh_shape_devices_and_refusals():
    m = cpu_mesh(tile_mesh, 3)
    assert isinstance(m, LocalMesh)
    assert m.shape == {"tiles": 3} and m.axis_names == ("tiles",)
    assert m.size == 3 and m.distinct() == (torch.device("cpu"),)
    assert cpu_mesh(sweep_mesh, 2).axis == "candidates"
    assert cpu_mesh(request_mesh, 2).axis == "requests"
    with pytest.raises(ValueError, match="at least one"):
        tile_mesh([])
    if not torch.cuda.is_available():
        # no quiet CPU mesh: a mesh over the visible cards needs cards
        for make in (tile_mesh, sweep_mesh, request_mesh):
            with pytest.raises(RuntimeError, match="is_available"):
                make()


def test_split_and_move_keep_shared_leaves_shared():
    x = torch.arange(12.0).reshape(6, 2)
    shared = torch.ones(3)[None].expand(6, 3)
    parts = split_leading({"x": x, "s": shared}, 3)
    assert [p["x"].tolist() for p in parts] == [x[0:2].tolist(),
                                                x[2:4].tolist(),
                                                x[4:6].tolist()]
    assert all(p["s"].stride(0) == 0 for p in parts)
    moved = to_device(parts[1], torch.device("cpu"))
    assert moved["x"] is parts[1]["x"]
    with pytest.raises(ValueError, match="equal shards"):
        split_leading({"x": x}, 4)
    assert tqat.pad_leading({"s": shared}, 8)["s"].stride(0) == 0


# --------------------------------------------------------------- profiler


def _tiles(seed, n, t_len):
    rng = np.random.default_rng(seed)
    w = rng.integers(-128, 128, (n, 64, 64)).astype(np.int32)
    a = rng.integers(-128, 128, (n, 64, t_len)).astype(np.int32)
    mask = np.ones(n, np.float32)
    mask[1] = 0.0                              # one masked tile
    return w, a, mask


@pytest.mark.parametrize("shards", [1, 3, 4])
def test_sharded_layer_stats_match_unsharded_and_jax(shards):
    w, a, mask = _tiles(0, 5, 12)              # 5 tiles: 3 and 4 pad
    tw, ta, tm = (torch.from_numpy(v) for v in (w, a, mask))
    want = batched_layer_stats(tw, ta, mask=tm)
    got = sharded_layer_stats(tw, ta, mask=tm,
                              mesh=cpu_mesh(tile_mesh, shards))
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    jw, ja, jm = (jnp.asarray(v) for v in (w, a, mask))
    for ref in (j_sharded_stats(jw, ja, mask=jm, mesh=j_tile_mesh()),
                j_batched_stats(jw, ja, mask=jm)):
        es, cnt, gh, ah = (np.asarray(v) for v in jax.device_get(ref))
        np.testing.assert_allclose(got[0].numpy(), es, rtol=1e-5)
        for x, y in zip(got[1:], (cnt, gh, ah)):
            np.testing.assert_array_equal(x.numpy(), y)


def test_profile_layer_mesh_equals_unsharded():
    rng = np.random.default_rng(3)
    w_mat = torch.from_numpy(rng.integers(-20, 20, (70, 130)).astype(
        np.int32))
    x_cols = torch.from_numpy(rng.integers(-128, 128, (130, 96)).astype(
        np.int32))
    want = profile_layer(w_mat, x_cols, max_tiles=7, seed=4)
    for shards in (2, 3):
        got = profile_layer(w_mat, x_cols, max_tiles=7, seed=4,
                            mesh=cpu_mesh(tile_mesh, shards))
        for f in ("energy_sum", "count", "group_hist", "act_hist"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert got.n_transitions == want.n_transitions


def test_runner_profile_mesh_equals_unsharded():
    runner = CnnRunner(tcnn.lenet5(), _TorchImages(), batch_size=4,
                       device="cpu")
    params, state, _, comp = runner.init()
    want = runner.profile(params, state, comp, max_tiles=3)
    meshed = CnnRunner(tcnn.lenet5(), _TorchImages(), batch_size=4,
                       device="cpu", profile_mesh=cpu_mesh(tile_mesh, 2))
    got = meshed.profile(params, state, comp, max_tiles=3)
    assert got.keys() == want.keys()
    for name in want:
        for f in ("energy_sum", "count", "group_hist", "act_hist"):
            assert torch.equal(getattr(got[name], f),
                               getattr(want[name], f)), (name, f)


def test_runner_refuses_a_mesh_of_another_axis():
    with pytest.raises(ValueError, match="candidates"):
        CnnRunner(tcnn.lenet5(), _TorchImages(), device="cpu",
                  sweep_mesh=cpu_mesh(tile_mesh, 2))
    with pytest.raises(TypeError, match="LocalMesh"):
        CnnRunner(tcnn.lenet5(), _TorchImages(), device="cpu",
                  profile_mesh=object())


# ------------------------------------------------------------------ sweep


class _NumpyImages:
    """A CIFAR-like numpy stream (smooth class templates, brightness jitter,
    pixel noise) handed to both packages' runners."""

    def __init__(self, seed=5, num_classes=10):
        rng = np.random.default_rng([seed, 99])
        up = np.kron(rng.normal(size=(num_classes, 8, 8, 3)),
                     np.ones((1, 4, 4, 1)))
        self.templates = (up / up.std()).astype(np.float32)
        self.seed, self.num_classes = seed, num_classes

    def arrays(self, step, batch_size, split):
        rng = np.random.default_rng([self.seed, _SPLIT[split], step])
        y = rng.integers(0, self.num_classes, batch_size)
        x = (self.templates[y] * (1 + 0.2 * rng.normal(size=(batch_size, 1,
                                                              1, 1)))
             + 0.45 * rng.normal(size=(batch_size, 32, 32, 3)))
        return x.astype(np.float32), y


class _JaxImages(_NumpyImages):
    def batch(self, step, batch_size, split="train"):
        x, y = self.arrays(step, batch_size, split)
        return jnp.asarray(x), jnp.asarray(y, jnp.int32)


class _TorchImages(_NumpyImages):
    def batch(self, step, batch_size, split="train", *, device):
        x, y = self.arrays(step, batch_size, split)
        return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


@pytest.fixture(scope="module")
def sweep():
    """Three LeNet-5 candidates (conv1 masks pruned at 0, 50 and 90%, fc1
    restricted to 8 values in the last) from JAX's initial parameters, as
    numpy trees."""
    jr = JRunner(jcnn.lenet5(), _JaxImages(), batch_size=BATCH, lr=2e-3)
    params, state, opt_state, comp = jax.device_get(jr.init())
    rng = np.random.default_rng(11)
    comps = []
    for i, keep in enumerate((1.0, 0.5, 0.1)):
        c = {n: dict(v) for n, v in comp.items()}
        shape = c["conv1"]["mask"].shape
        c["conv1"]["mask"] = (rng.random(shape) < keep).astype(np.float32)
        if i == 2:
            cb = np.zeros(32, np.int32)
            cb[:8] = np.arange(-64, 64, 16)
            cb[8:] = cb[7]
            c["fc1"]["codebook"], c["fc1"]["codebook_k"] = cb, np.int32(8)
        comps.append(c)
    return params, state, opt_state, comps


def _stacked(tqat_or_jqat, tree, comps, to):
    stack = tqat_or_jqat.stack_pytrees
    bcast = tqat_or_jqat.broadcast_pytree
    params, state, opt_state = (bcast(to(t), 3) for t in tree)
    return params, state, opt_state, stack([to(c) for c in comps])


def _port_runner(mesh=None):
    return CnnRunner(tcnn.lenet5(), _TorchImages(), batch_size=BATCH,
                     lr=2e-3, device="cpu", sweep_mesh=mesh)


def test_sharded_sweep_equals_unsharded_bit_for_bit(sweep):
    """3 candidates on a 2-shard mesh (padded to 4): the trained trees, the
    losses and every accuracy equal the unsharded sweep's."""
    params, state, opt_state, comps = sweep
    trees = _stacked(tqat, (params, state, opt_state), comps, j2t)
    plain, meshed = _port_runner(), _port_runner(cpu_mesh(sweep_mesh, 2))
    want = plain.train_batched(*trees, 2)
    got = meshed.train_batched(*trees, 2)
    for a, b in zip(got[:3], want[:3]):
        assert_trees_equal(a, b)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].shape == (3,)
    stacked = trees[3]
    np.testing.assert_array_equal(
        meshed.accuracy_batched(got[0], got[1], stacked, n_batches=2),
        plain.accuracy_batched(want[0], want[1], stacked, n_batches=2))
    p0, s0 = j2t(params), j2t(state)
    np.testing.assert_array_equal(
        meshed.accuracy_comps(p0, s0, stacked, n_batches=2),
        plain.accuracy_comps(p0, s0, stacked, n_batches=2))
    idx = [2, 0, 1]
    np.testing.assert_array_equal(
        meshed.accuracy_gather(got[0], got[1], stacked, idx, n_batches=2),
        plain.accuracy_gather(want[0], want[1], stacked, idx, n_batches=2))


def test_sharded_sweep_matches_jax_sweep_mesh(sweep):
    """The port's 2-shard sweep against JAX's ``CnnRunner(sweep_mesh=
    sweep_mesh())`` on the same batches and initial parameters."""
    from repro.core import qat as jqat

    params, state, opt_state, comps = sweep
    jr = JRunner(jcnn.lenet5(), _JaxImages(), batch_size=BATCH, lr=2e-3,
                 sweep_mesh=j_sweep_mesh())
    jtrees = _stacked(jqat, (params, state, opt_state), comps,
                      lambda t: jax.tree.map(jnp.asarray, t))
    jp, js, _, jloss = jr.train_batched(*jtrees, 1)
    meshed = _port_runner(cpu_mesh(sweep_mesh, 2))
    ttrees = _stacked(tqat, (params, state, opt_state), comps, j2t)
    tp, _, _, tloss = meshed.train_batched(*ttrees, 1)
    np.testing.assert_allclose(tloss, np.asarray(jloss), rtol=1e-5)
    jp_np = jax.device_get(jp)
    for i in range(3):
        assert rel_l2([x[i] for x in tree_leaves(tp)],
                      [np.asarray(x)[i] for x in jax.tree.leaves(jp_np)]) \
            < 1e-3
    stacked_t, stacked_j = ttrees[3], jtrees[3]
    np.testing.assert_array_equal(
        meshed.accuracy_batched(j2t(jp), j2t(js), stacked_t, n_batches=2),
        jr.accuracy_batched(jp, js, stacked_j, n_batches=2))
    np.testing.assert_array_equal(
        meshed.accuracy_comps(j2t(params), j2t(state), stacked_t,
                              n_batches=2),
        jr.accuracy_comps(jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, state), stacked_j,
                          n_batches=2))


# ---------------------------------------------------------------- serving


ENGINE = dict(max_batch=4, prompt_buckets=(8,), new_token_buckets=(8,),
              max_waves=1)


@pytest.fixture(scope="module")
def lm():
    jm = jbuild(jget("olmo-1b").scaled_down(compute_dtype="float32"))
    tm = tbuild(tget("olmo-1b").scaled_down(compute_dtype="float32"))
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jm.cfg.vocab, 8).astype(np.int32)
               for _ in range(6)]
    return jm, tm, jp, j2t(jp), prompts


def _served(engine, prompts):
    """(tokens of each request, every logits array the engine read back)."""
    seen = []
    host = engine._host

    def record(logits, vocab):
        out = host(logits, vocab)
        seen.append(out)
        return out

    engine._host = record
    engine.warmup([(8, 8)])
    res = engine.serve([ServeRequest(tokens=p, max_new_tokens=8)
                        for p in prompts])
    return [r.tokens for r in res], seen


@pytest.mark.parametrize("plan", ["uncompressed", "k4"])
def test_wave_engine_on_a_request_mesh_equals_unsharded(lm, plan):
    """6 requests in waves of 4: the first wave's rows split over 2 shards,
    tokens and float32 logits equal the engine's without a mesh; the
    shards' builds count in the engine's step cache."""
    _, tm, _, tp, prompts = lm
    handle = (PlanHandle.uncompressed() if plan == "uncompressed"
              else PlanHandle.from_compress_k(tm, 4, device="cpu"))
    cfg = EngineConfig(**ENGINE)
    plain = ServingEngine(tm, tp, mode="wave", config=cfg, plan=handle,
                          device="cpu")
    meshed = ServingEngine(tm, tp, mode="wave", config=cfg, plan=handle,
                           mesh=cpu_mesh(request_mesh, 2), device="cpu")
    want, want_logits = _served(plain, prompts)
    got, got_logits = _served(meshed, prompts)
    assert got == want
    assert len(got_logits) == len(want_logits)
    for a, b in zip(got_logits, want_logits):
        np.testing.assert_array_equal(a, b)
    # one build a shard-row bucket (prefill + decode), no build after warmup
    assert meshed.cache.compile_count == plain.cache.compile_count == 2


def test_engine_mesh_tokens_match_jax_engine_with_request_mesh(lm):
    """The port's wave engine on a 2-shard CPU mesh against JAX's wave
    engine with ``mesh=request_mesh()``: uncompressed, exact-fit prompts,
    greedy tokens equal."""
    jm, tm, jp, tp, prompts = lm
    jengine = JServingEngine(jm, jp, mode="wave",
                             config=JEngineConfig(**ENGINE),
                             mesh=j_request_mesh())
    jengine.warmup([(8, 8)])
    want = [r.tokens for r in jengine.serve(
        [JServeRequest(tokens=p, max_new_tokens=8) for p in prompts[:4]])]
    meshed = ServingEngine(tm, tp, mode="wave", config=EngineConfig(**ENGINE),
                           mesh=cpu_mesh(request_mesh, 2), device="cpu")
    got, _ = _served(meshed, prompts[:4])
    assert got == want


def test_slot_engine_on_a_mesh_runs_on_the_first_device(lm):
    _, tm, _, tp, prompts = lm
    cfg = EngineConfig(**ENGINE)
    meshed = ServingEngine(tm, tp, config=cfg,
                           mesh=cpu_mesh(request_mesh, 2), device="cpu")
    plain = ServingEngine(tm, tp, config=cfg, device="cpu")
    assert _served(meshed, prompts)[0] == _served(plain, prompts)[0]


def test_engine_mesh_refusals(lm):
    _, tm, _, tp, _ = lm
    cfg = EngineConfig(**ENGINE)
    with pytest.raises(TypeError, match="LocalMesh"):
        ServingEngine(tm, tp, config=cfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="requests"):
        ServingEngine(tm, tp, config=cfg, mesh=cpu_mesh(sweep_mesh, 2),
                      device="cpu")


def test_wave_fleet_on_a_request_mesh_routes_and_serves_as_without(lm):
    _, tm, _, tp, prompts = lm
    handles = [PlanHandle.uncompressed(),
               PlanHandle.from_compress_k(tm, 4, device="cpu")]
    router = RouterConfig(high_watermark=0.5, low_watermark=0.25,
                          hysteresis=2)
    out = {}
    for name, mesh in (("plain", None), ("mesh", cpu_mesh(request_mesh, 2))):
        fleet = FleetRouter(tm, tp, handles, mode="wave",
                            config=EngineConfig(**ENGINE), router=router,
                            mesh=mesh, device="cpu")
        fleet.warmup([(8, 8)])
        rids = [fleet.submit(ServeRequest(tokens=p, max_new_tokens=8))
                for p in prompts]
        res = fleet.run()
        out[name] = (fleet.route_log, [res[r].tokens for r in rids])
    assert out["mesh"] == out["plain"]
    assert len({e["plan_id"] for e in out["mesh"][0]}) == 2   # both routed
