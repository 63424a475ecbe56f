"""Port parity for the bit-accurate systolic cosim (`repro_torch.cosim`)
against the JAX package's `repro.cosim`, exactly, in integers: the 22-bit
primitives, the cycle-by-cycle PE-array trace, the per-tile and batched
statistics, `verify_tiles` dict for dict, and the CNN profile stage's
``verify_cosim`` gate (its metrics, the CLI flag, a plan the JAX package
loads, and a moved kernel count that makes the stage raise).

The port's `verify_tiles` holds K1's integer histogram (its plain version
on these CPU tensors) against the cosim; the JAX side runs its jnp oracle
(``use_kernel=False``), whose float32 histogram is exact at these sizes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cosim as jcosim
from repro.pipeline.plan import CompressionPlan as JPlan
from repro.pipeline.schema import validate_plan_doc
from repro_torch import cosim as tcosim
from repro_torch.core import profiler as tprofiler
from repro_torch.core.stats import TILE, tile_psum_trace
from repro_torch.nn import cnn as tcnn
from repro_torch.pipeline import cli
from repro_torch.pipeline.config import reduced_cnn_config
from repro_torch.pipeline.pipeline import Pipeline as TPipeline

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work in this file runs on one thread: beside the
    suite's parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boundary_values():
    """Every 22-bit boundary: 0, +-2^b and its neighbours for b in 0..22,
    MASK22 and the int32 extremes, then random int32 patterns."""
    vals = {0, (1 << 31) - 1, -(1 << 31), tcosim.MASK22, -tcosim.MASK22}
    for b in range(tcosim.PSUM_BITS + 1):
        for v in ((1 << b) - 1, 1 << b, (1 << b) + 1):
            vals.update((v, -v))
    rng = np.random.default_rng(0)
    rand = rng.integers(-(1 << 31), 1 << 31, 4096, dtype=np.int64)
    return np.concatenate([np.array(sorted(vals), np.int64), rand]
                          ).astype(np.int32)


def _tiles(seed, n, t_len, lo=-128, hi=128, k=TILE, m=TILE):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, hi, (n, k, m)).astype(np.int32),
            rng.integers(lo, hi, (n, k, t_len)).astype(np.int32))


# ------------------------------------------------------------ primitives


@pytest.mark.parametrize("fn", ["bits22", "ref_popcount22", "ref_msb_val22",
                                "ref_group_id"])
def test_primitives_match_jax_on_every_boundary(fn):
    x = _boundary_values()
    got = getattr(tcosim, fn)(torch.from_numpy(x))
    want = np.asarray(getattr(jcosim, fn)(jnp.asarray(x)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_constants_match_jax():
    for name in ("PSUM_BITS", "MASK22", "N_MSB_GROUPS", "N_HD_SUBGROUPS",
                 "N_GROUPS"):
        assert getattr(tcosim, name) == getattr(jcosim, name), name


# ------------------------------------------------------------ the array


@pytest.mark.parametrize("k,m,t", [(64, 64, 33), (16, 8, 5), (5, 9, 2),
                                   (64, 64, 2)])
def test_pe_array_trace_matches_jax_and_the_prefix_sums(k, m, t):
    """Non-square arrays and T = 2: the cycle trace equals JAX's and the
    unskewed prefix sums of `core.stats.tile_psum_trace`."""
    w, a = _tiles(k * m + t, 1, t, k=k, m=m)
    got = tcosim.pe_array_trace(torch.from_numpy(w[0]), torch.from_numpy(a[0]))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcosim.pe_array_trace(w[0], a[0])))
    np.testing.assert_array_equal(
        got.numpy(), tile_psum_trace(torch.from_numpy(w[0]),
                                     torch.from_numpy(a[0])).numpy())


def test_pe_array_trace_hand_computed():
    """2x2 array, 2-element stream, checked by hand."""
    w = torch.tensor([[1, -2], [3, 4]], dtype=torch.int32)
    a = torch.tensor([[5, -6], [7, 8]], dtype=torch.int32)
    want = [[[5, -6], [-10, 12]], [[5 + 21, -6 + 24], [-10 + 28, 12 + 32]]]
    assert tcosim.pe_array_trace(w, a).tolist() == want


@pytest.mark.parametrize("t_len,lo,hi", [(17, -128, 128), (2, -128, 128),
                                         (8, 0, 128), (16, -128, 1)])
def test_tile_stats_match_jax(t_len, lo, hi):
    w, a = _tiles(t_len + hi, 1, t_len, lo, hi)
    hist, toggles = tcosim.tile_cosim_stats(torch.from_numpy(w[0]),
                                            torch.from_numpy(a[0]))
    jhist, jtoggles = jcosim.tile_cosim_stats(w[0], a[0])
    assert hist.dtype == toggles.dtype == torch.int32
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    assert int(toggles) == int(jtoggles)
    assert int(hist.sum()) == TILE * TILE * (t_len - 1)


@pytest.mark.parametrize("chunk", [None, 2])
def test_batched_stats_with_a_mask_match_jax(chunk):
    """Masked tiles contribute nothing; the chunking changes nothing."""
    w, a = _tiles(3, 5, 9)
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    hist, toggles = tcosim.cosim_batched_stats(
        torch.from_numpy(w), torch.from_numpy(a),
        mask=torch.from_numpy(mask), chunk=chunk)
    jhist, jtoggles = jcosim.cosim_batched_stats(w, a, mask=mask)
    assert hist.dtype == np.int64 and isinstance(toggles, int)
    np.testing.assert_array_equal(hist, jhist)
    assert toggles == jtoggles
    kept, kept_t = tcosim.cosim_batched_stats(
        torch.from_numpy(w[mask != 0]), torch.from_numpy(a[mask != 0]))
    np.testing.assert_array_equal(hist, kept)
    assert toggles == kept_t


# ------------------------------------------------------------ the gate


def _profiled_tiles(stats):
    """Tiles behind a plan's statistics: T = 64 columns a tile, so each
    tile makes 64 x 64 x 63 transitions."""
    return sum(int(st.n_transitions) for st in stats.values()) \
        // (TILE * TILE * (TILE - 1))


def _cases():
    w, a = _tiles(11, 3, 33)
    ones = np.ones((1, TILE, TILE), np.int32)
    sign = np.broadcast_to(np.tile(np.array([3, -3], np.int32), 8),
                           (1, TILE, 16)).copy()
    big = np.full((1, TILE, TILE), 127, np.int32)
    swing = np.broadcast_to(np.tile(np.array([127, -128], np.int32), 5),
                            (1, TILE, 10)).copy()
    return {
        "random": (w, a, None),
        "masked": (w, a, np.array([1.0, 0.0, 1.0], np.float32)),
        "t2": (w, a[:, :, :2].copy(), None),
        "zero_weights": (np.zeros_like(ones), _tiles(1, 1, 12)[1], None),
        "sign_flips": (ones, sign, None),
        "max_positive": (big, np.full((1, TILE, 10), 127, np.int32), None),
        "max_negative": (big, np.full((1, TILE, 10), -128, np.int32), None),
        "swing": (big, swing, None),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_verify_tiles_matches_jax_dict_for_dict(case):
    w, a, mask = _cases()[case]
    got = tcosim.verify_tiles(torch.from_numpy(w), torch.from_numpy(a),
                              mask=None if mask is None
                              else torch.from_numpy(mask))
    want = jcosim.verify_tiles(w, a, mask=mask, use_kernel=False)
    assert got == want
    assert got["match"] and got["max_abs_diff"] == 0.0


def test_profile_stage_with_verify_cosim_gates_every_layer(tmp_path):
    """The reduced LeNet-5 profile with ``verify_cosim``: the cosim
    metrics (every bin equal) over the tiles the plan's statistics came
    from (up to 4 a layer), and a plan the JAX package loads and
    validates."""
    cfg = reduced_cnn_config().with_overrides(
        {"train": {"qat_steps": 0}, "profile": {"verify_cosim": True}})
    plan = TPipeline(cfg, device="cpu").run_until("profile")
    m = plan.metrics
    assert m["cosim_match"] is True and m["cosim_max_abs_diff"] == 0.0
    assert m["cosim_tiles"] == _profiled_tiles(plan.stats) == 18
    assert m["cosim_toggles"] > 0
    plan.save(tmp_path / "plan")
    doc = json.loads((tmp_path / "plan.json").read_text())
    assert not [g for g in validate_plan_doc(doc) if not g["pass"]]
    assert JPlan.load(tmp_path / "plan").metrics["cosim_match"] is True


def test_cli_verify_cosim_flag(tmp_path):
    """``profile --verify-cosim`` writes the cosim metrics; the flag also
    overrides a resumed plan's config, as in the JAX package."""
    out = tmp_path / "profiled"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "profile", "--reduced",
         "--steps", "0", "--verify-cosim", "--device", "cpu", "--quiet",
         "--plan-out", str(out)], capture_output=True, text=True,
        cwd=tmp_path, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    metrics = json.loads(out.with_suffix(".json").read_text())["metrics"]
    assert metrics["cosim_match"] is True
    assert metrics["cosim_tiles"] == _profiled_tiles(JPlan.load(out).stats)
    for command in ("profile", "compress", "export", "serve"):
        args = cli.build_parser().parse_args(
            [command, "--plan-in", str(out), "--verify-cosim"])
        assert cli._overrides(args)["profile"] == {"verify_cosim": True}
        args = cli.build_parser().parse_args([command, "--plan-in", str(out)])
        assert "profile" not in cli._overrides(args)


def test_a_moved_kernel_count_makes_the_stage_raise(monkeypatch):
    """One count of one layer's K1 histogram moved to the next bin: the
    gate raises `RuntimeError` naming that layer, and only that layer."""
    names = [cl.name for cl in tcnn.lenet5().comp_layers]
    victim = names[2]
    real = tprofiler.batched_layer_counts
    calls = []

    def moved(w_tiles, a_blocks, *, mask=None):
        events, group_hist, act_hist = real(w_tiles, a_blocks, mask=mask)
        if names[len(calls)] == victim:
            group_hist = group_hist.clone()
            src = int(torch.nonzero(group_hist)[0])
            group_hist[src] -= 1
            group_hist[src + 1] += 1
        calls.append(victim)
        return events, group_hist, act_hist

    monkeypatch.setattr(tprofiler, "batched_layer_counts", moved)
    cfg = reduced_cnn_config().with_overrides(
        {"train": {"qat_steps": 0}, "profile": {"verify_cosim": True}})
    with pytest.raises(RuntimeError, match="cosim") as e:
        TPipeline(cfg, device="cpu").run_until("profile")
    assert f"'{victim}': 1.0" in str(e.value)
    assert not any(f"'{n}'" in str(e.value) for n in names if n != victim)
    assert len(calls) == len(names)
