"""The port's logical-axis sharding rules against the JAX package's, on
abstract meshes (no process, no device): every `PartitionSpec`, every
guard-report line and every local shard shape of the parameter, train
state, comp, batch and decode-cache shardings of all ten archs of
``configs.ALL_ARCHS`` at full width, on JAX's ``AbstractMesh`` and the
port's `AbstractMesh` of the same shape (16 x 16, 2 x 16 x 16, 2 x 4,
1 x 1); the slice each mesh position holds against JAX's device -> index
map (a JAX subprocess with eight host devices); `ShardingRules.replace`;
the dry run's per-device bytes against the bytes of JAX's local shard
shapes; the production meshes. Exact: these are integer layouts.
"""

import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import ALL_ARCHS, SHAPES
from repro.configs import get_config as jget
from repro.distributed import sharding as jsh
from repro.launch import train as jtrain
from repro.models.lm import build_lm as jbuild
from repro.nn.spec import flatten_with_names as jflat
from repro_torch.configs import get_config as tget
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn.spec import flatten_with_names as tflat

ROOT = Path(__file__).resolve().parents[1]

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
CASES = [(a, m) for a in ALL_ARCHS for m in MESHES]


def ids(case):
    return f"{case[0]}-{case[1]}"


@lru_cache(maxsize=None)
def models(arch):
    return jbuild(jget(arch)), tbuild(tget(arch))


@lru_cache(maxsize=None)
def meshes(name):
    sizes, axes = MESHES[name]
    return JAbstractMesh(sizes, axes), tsh.AbstractMesh(sizes, axes)


def same_layout(jtree, ttree, shapes):
    """Every leaf's spec and local shard shape equal (``shapes``: name ->
    global shape)."""
    jf, tf = jflat(jtree), tflat(ttree)
    assert sorted(jf) == sorted(tf)
    for name, js in jf.items():
        ts = tf[name]
        assert tuple(ts.spec) == tuple(js.spec), name
        assert tuple(ts.shard_shape(shapes[name])) == \
            tuple(js.shard_shape(shapes[name])), name
    return len(jf)


def spec_shapes(spec_tree):
    return {k: tuple(v.shape) for k, v in tflat(spec_tree).items()}


# ------------------------------------------------------------------ rules


def test_default_rules_and_replace_match_jax():
    assert tsh.DEFAULT_RULES.rules == jsh.DEFAULT_RULES.rules
    for kw in ({"embed": "model", "heads": None},
               {"batch": ("data",), "new_axis": "pod"},
               {"moe_ff": "model", "expert": None}, {}):
        assert tsh.DEFAULT_RULES.replace(**kw).rules == \
            jsh.DEFAULT_RULES.replace(**kw).rules
    for logical in ("batch", "embed", "layers", "nope", None):
        assert tsh.DEFAULT_RULES.lookup(logical) == \
            jsh.DEFAULT_RULES.lookup(logical)


LOGICAL = [
    (("batch", None, "embed"), (256, 4096, 2048)),
    (("embed", "heads", None), (2560, 10, 256)),       # 10 heads: guarded
    (("vocab", "embed"), (50304, 2048)),
    (("embed", "embed"), (64, 64)),                      # data used twice
    (("batch", "kv_seq", None, None), (1, 524288, 1, 256)),
    (("expert", "moe_embed", "moe_ff"), (16, 4096, 6400)),
    ((None, "mlp"), (7, 33)),
]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("axes,shape", LOGICAL)
def test_logical_to_spec_matches_jax(mesh_name, axes, shape):
    jm, tm = meshes(mesh_name)
    for rules in ((jsh.DEFAULT_RULES, tsh.DEFAULT_RULES),
                  (jsh.DEFAULT_RULES.replace(embed="model", heads=None),
                   tsh.DEFAULT_RULES.replace(embed="model", heads=None))):
        jg, tg = [], []
        js = jsh.logical_to_spec(axes, shape, jm, rules[0], guard_report=jg,
                                 tensor_name="x".join(map(str, shape)))
        ts = tsh.logical_to_spec(axes, shape, tm, rules[1], guard_report=tg,
                                 tensor_name="x".join(map(str, shape)))
        assert tuple(ts) == tuple(js)
        assert tg == jg


# ---------------------------------------------------------- model layouts


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_param_shardings_match_jax(case):
    arch, mesh_name = case
    (jm_, tm_), (jmesh, tmesh_) = models(arch), meshes(mesh_name)
    jg, tg = [], []
    js = jsh.make_param_shardings(jm_.spec, jmesh, guard_report=jg)
    ts = tsh.make_param_shardings(tm_.spec, tmesh_, guard_report=tg)
    assert same_layout(js, ts, spec_shapes(tm_.spec)) > 0
    assert tg == jg


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_train_state_and_comp_shardings_match_jax(case):
    arch, mesh_name = case
    (jm_, tm_), (jmesh, tmesh_) = models(arch), meshes(mesh_name)
    jg, tg = [], []
    js = jtrain.train_state_shardings(jm_, jmesh, guard_report=jg)
    ts = ttrain.train_state_shardings(tm_, tmesh_, guard_report=tg)
    shapes = {k: tuple(v.shape)
              for k, v in tflat(ttrain.abstract_train_state(tm_)).items()}
    assert same_layout(js, ts, shapes) == len(shapes)
    jc = jtrain.comp_shardings(jm_, jmesh, guard_report=jg)
    tc = ttrain.comp_shardings(tm_, tmesh_, guard_report=tg)
    cshapes = {k: tuple(v.shape)
               for k, v in tflat(ttrain.comp_abstract(tm_)).items()}
    assert same_layout(jc, tc, cshapes) == len(cshapes)
    assert tg == jg
    # the abstract trees: shapes and dtypes of JAX's
    jstate = jflat(jtrain.abstract_train_state(jm_))
    for name, t in tflat(ttrain.abstract_train_state(tm_)).items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(jstate[name].shape), name
        assert str(t.dtype).split(".")[1] == str(jstate[name].dtype), name
    jserve = jflat(jtrain.abstract_serve_params(jm_))
    for name, t in tflat(ttrain.abstract_serve_params(tm_)).items():
        assert t.dtype == torch.bfloat16 and \
            tuple(t.shape) == tuple(jserve[name].shape)


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_batch_shardings_match_jax(case):
    arch, mesh_name = case
    jmesh, tmesh_ = meshes(mesh_name)
    for shape_name in ("train_4k", "prefill_32k"):
        jspecs = jtrain.batch_specs(jget(arch), SHAPES[shape_name])
        tspecs = ttrain.batch_specs(tget(arch), SHAPES[shape_name])
        jb = jtrain.batch_shardings(jspecs, jmesh)
        tb = ttrain.batch_shardings(tspecs, tmesh_)
        same_layout(jb, tb, {k: tuple(v.shape) for k, v in tspecs.items()})
    for b in (1, 3, 8, 64):     # a batch that does not divide replicates
        shape = (b, 16, 32)
        assert tuple(tsh.batch_sharding(tmesh_, shape).spec) == \
            tuple(jsh.batch_sharding(jmesh, shape).spec)


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_cache_axes_and_shardings_match_jax(case):
    arch, mesh_name = case
    (jm_, tm_), (jmesh, tmesh_) = models(arch), meshes(mesh_name)
    for shape_name in ("decode_32k", "long_500k"):
        shape = SHAPES[shape_name]
        if shape_name == "long_500k" and tm_.cfg.family not in (
                "ssm", "hybrid"):
            continue
        tspec = ttrain.decode_cache_specs(tm_, shape)
        jspec_ = jtrain.decode_cache_specs(jm_, shape)
        shapes = {k: tuple(v.shape) for k, v in tflat(tspec).items()}
        for kv_seq in (False, True):
            assert tflat(ttrain.cache_axes(tspec, kv_seq_shard=kv_seq)) == \
                jflat(jtrain.cache_axes(jspec_, kv_seq_shard=kv_seq))
            jg, tg = [], []
            jc = jtrain.cache_shardings(jm_, shape, jmesh, guard_report=jg,
                                        kv_seq_shard=kv_seq)
            tc = ttrain.cache_shardings(tm_, shape, tmesh_, guard_report=tg,
                                        kv_seq_shard=kv_seq)
            same_layout(jc, tc, shapes)
            assert tg == jg


# ------------------------------------------------------ slices and meshes


ORDER_CASES = [
    ((2, 4), ("data", "model"), (("data", "model"), None), (16, 8)),
    ((2, 4), ("data", "model"), ("model", "data"), (8, 6)),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), "model"),
     (8, 4)),
    ((2, 2, 2), ("pod", "data", "model"), (None, ("pod", "data")), (3, 8)),
    ((2, 2, 2), ("pod", "data", "model"), ("model", None, "data"),
     (4, 5, 6)),
]
_ORDER_SCRIPT = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec
cases = json.loads(sys.argv[1])
out = []
for sizes, axes, spec, shape in cases:
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(
        sizes), tuple(axes))
    spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
    idx = NamedSharding(mesh, PartitionSpec(*spec)).devices_indices_map(
        tuple(shape))
    pos = {d: p for p, d in np.ndenumerate(mesh.devices)}
    out.append(sorted(
        [list(map(int, pos[d])),
         [[s.start or 0, s.stop if s.stop is not None else n]
          for s, n in zip(sl, shape)]] for d, sl in idx.items()))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_orders():
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    res = subprocess.run(
        [sys.executable, "-c", _ORDER_SCRIPT, json.dumps(ORDER_CASES)],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("i", range(len(ORDER_CASES)))
def test_position_slices_follow_jax_device_order(i, jax_orders):
    sizes, axes, spec, shape = ORDER_CASES[i]
    mesh = tsh.AbstractMesh(sizes, axes)
    s = tsh.NamedSharding(mesh, tsh.PartitionSpec(*spec))
    got = []
    for pos in torch.cartesian_prod(*[torch.arange(n) for n in sizes]) \
            .reshape(-1, len(sizes)).tolist():
        coords = dict(zip(axes, pos))
        sl = s.index(shape, coords)
        got.append([pos, [[x.start or 0, x.stop if x.stop is not None
                           else n] for x, n in zip(sl, shape)]])
    assert sorted(got) == jax_orders[i]
    # DTensor's placements: Shard(d) on each mesh dim the spec names at d
    if all(list(tsh._axes_of(e)) == [a for a in axes
                                     if a in tsh._axes_of(e)]
           for e in spec):
        from torch.distributed.tensor import Replicate, Shard

        want = [Replicate()] * len(axes)
        for d, e in enumerate(spec):
            for a in tsh._axes_of(e):
                want[axes.index(a)] = Shard(d)
        assert s.placements == tuple(want)
    else:
        with pytest.raises(ValueError, match="axis order"):
            s.placements


def test_production_meshes():
    m = tmesh.make_production_mesh(abstract=True)
    assert m.shape == {"data": 32, "model": 8} and m.size == 256
    mp = tmesh.make_production_mesh(multi_pod=True, abstract=True)
    assert mp.shape == {"pod": 2, "data": 32, "model": 8} and mp.size == 512
    assert tmesh.mesh_label(mp) == "2x32x8"
    with pytest.raises(RuntimeError, match="needs 256 processes, found 1"):
        tmesh.make_production_mesh()
    with pytest.raises(TypeError, match="no processes"):
        m.coords
    one = tsh.AbstractMesh((1, 1), ("data", "model"))
    assert one.group(("data",)) is None and one.coords == {"data": 0,
                                                           "model": 0}


# --------------------------------------------------------------- dry run


def jax_device_bytes(tree, shardings):
    import numpy as np

    jt, js = jflat(tree), jflat(shardings)
    return sum(int(np.prod(js[k].shard_shape(v.shape))) * v.dtype.itemsize
               for k, v in jt.items())


DRY_CELLS = [("olmo-1b", "train_4k"), ("phi3.5-moe-42b-a6.6b", "prefill_32k"),
             ("whisper-large-v3", "decode_32k"),
             ("recurrentgemma-2b", "long_500k")]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape_name", DRY_CELLS)
def test_dryrun_bytes_match_jax_shard_shapes(arch, shape_name, multi_pod):
    import jax
    import jax.numpy as jnp

    got = tdry.run_cell(arch, shape_name, multi_pod)
    sizes, axes = tmesh.production_mesh_layout(multi_pod=multi_pod)
    jmesh = JAbstractMesh(sizes, axes)
    jm_ = models(arch)[0]
    shape = SHAPES[shape_name]
    guard: list = []
    want = {}
    if shape.kind == "train":
        state = jtrain.abstract_train_state(jm_)
        sh = jtrain.train_state_shardings(jm_, jmesh, guard_report=guard)
        want["params"] = jax_device_bytes(state["params"], sh["params"])
        want["opt"] = jax_device_bytes(state["opt"], sh["opt"])
        want["comp"] = jax_device_bytes(
            jtrain.comp_abstract(jm_),
            jtrain.comp_shardings(jm_, jmesh, guard_report=guard))
        specs = jtrain.batch_specs(jget(arch), shape)
        want["batch"] = jax_device_bytes(
            specs, jtrain.batch_shardings(specs, jmesh))
    else:
        want["params"] = jax_device_bytes(
            jtrain.abstract_serve_params(jm_),
            jsh.make_param_shardings(jm_.spec, jmesh, guard_report=guard))
        if shape.kind == "prefill":
            specs = jtrain.batch_specs(jget(arch), shape)
        else:
            want["cache"] = jax_device_bytes(
                jtrain.decode_cache_specs(jm_, shape),
                jtrain.cache_shardings(jm_, shape, jmesh,
                                       guard_report=guard))
            specs = {"tokens": jax.ShapeDtypeStruct((shape.batch, 1),
                                                    jnp.int32)}
        want["batch"] = jax_device_bytes(
            specs, jtrain.batch_shardings(specs, jmesh))
    want["total"] = sum(want.values())
    assert got["status"] == "ok"
    assert got["per_device_bytes"] == want
    assert got["guard_report"] == guard
    assert got["n_devices"] == int(jmesh.size)


def test_dryrun_all_writes_every_cell(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out-dir", str(tmp_path)], capture_output=True, text=True,
        env=env, timeout=300, check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "ok": 64, "skipped": 16}
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == len(ALL_ARCHS) * len(SHAPES) * 2
    for f in files:
        cell = json.loads(f.read_text())
        assert cell["mesh"] in ("32x8", "2x32x8")
        if cell["status"] == "ok":
            assert cell["per_device_bytes"]["total"] > 0
            assert cell["n_devices"] in (256, 512)
            assert cell["gathered_peak_bytes"] > 0
            assert cell["per_device_peak_bytes"] == (
                cell["per_device_bytes"]["total"]
                + cell["gathered_peak_bytes"])
            assert cell["flops"]["total"] == sum(
                cell["flops"]["by_unit"].values()) > 0
            assert cell["collectives"]["total_bytes"] == sum(
                cell["collectives"][k]["bytes"]
                for k in ("all-gather", "reduce-scatter", "all-reduce"))
        else:
            assert cell["shape"] == "long_500k" and cell["skip_reason"]


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "qwen2.5-14b"])
def test_dryrun_train_cells_fit_one_card_gathering_a_block(arch):
    """A meshed train step gathers one block at a time: the dry run's
    gathered bytes a device are the embedding plus the largest block's
    parameters, fake-quantized copy and gradient (a tensor-parallel unit's
    chunk over "model"), well below the whole model's parameters the step
    once gathered, and with the arguments they fit one 80 GB card on the
    32 x 8 mesh."""
    cell = tdry.run_cell(arch, "train_4k", False)
    model = tbuild(tget(arch))
    params = tflat(ttrain.abstract_train_state(model)["params"])
    whole = sum(t.numel() * t.element_size() for t in params.values())
    assert cell["mesh"] == "32x8"
    assert cell["gathered_peak_bytes"] == tdry.gathered_peak_bytes(
        model, "train", tmesh.make_production_mesh(abstract=True))
    assert cell["gathered_peak_bytes"] < whole / 5
    assert cell["per_device_peak_bytes"] < 80e9
