"""Port parity for routing calibration and the routed targets
(`repro_torch.core.routing_stats`, `MoETarget`, `ScanTarget`): the share
and k-ladder arithmetic, calibration on the same injected tokens for the
reduced phi3.5-moe, moonshot, mamba2 and recurrentgemma, the stage
boundary in both directions (JAX's profile plan resumed by the port
through export, the port's plan read back by the JAX package), and the
CLI.

The JAX package draws calibration tokens from a ``jax.random`` chain and
the port from ``np.random.default_rng``, so the calibration comparisons
inject the same numpy batches into both (JAX's `calibration_batches`
patched). Tolerances and why:
  * kept-dispatch counts, ``expected_units``, decisions (k, traffic
    share), comp trees and exported artifacts: equal (integer counts; the
    shares are the same numpy arithmetic on them);
  * scan activity: rel 1e-5 (a float32 mean square of the same float32
    activations, summed in another order);
  * unit energies: rel 1e-5 (float32 sums of the same integer counts
    against the same LUT, the JAX package's, patched in).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import energy_lut as jelut
from repro.core import routing_stats as jrs
from repro.models.lm import build_lm as jbuild
from repro.nn.spec import init_params as jinit
from repro.pipeline import targets as jtargets
from repro.pipeline.config import reduced_moe_config as j_reduced_moe
from repro.pipeline.config import reduced_scan_config as j_reduced_scan
from repro.pipeline.pipeline import Pipeline as JPipeline
from repro.pipeline.plan import CompressionPlan as JPlan
from repro_torch.configs import get_config as tget
from repro_torch.core import routing_stats as trs
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn.spec import params_from_numpy
from repro_torch.pipeline import targets as ttargets
from repro_torch.pipeline.config import reduced_moe_config as t_reduced_moe
from repro_torch.pipeline.config import reduced_scan_config as t_reduced_scan
from repro_torch.pipeline.pipeline import Pipeline as TPipeline
from repro_torch.pipeline.plan import CompressionPlan as TPlan

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b", "mamba2-1.3b",
         "recurrentgemma-2b")
KINDS = {"moe": (j_reduced_moe, t_reduced_moe, "phi3.5-moe-42b-a6.6b"),
         "scan": (j_reduced_scan, t_reduced_scan, "mamba2-1.3b")}
ART_FIELDS = ("packed", "codebook", "scale")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work in this file runs on one thread: beside the
    suite's parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t2n(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------ arithmetic


def test_shares_rank_k_and_weighted_energy_match_jax():
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 9, (3, 6)).astype(np.float64)
    counts[1] = 0                                   # no traffic: uniform
    counts[2, :3] = 5                               # ties
    np.testing.assert_array_equal(trs.traffic_shares(counts),
                                  jrs.traffic_shares(counts))
    np.testing.assert_array_equal(trs.traffic_shares(counts[0]),
                                  jrs.traffic_shares(counts[0]))
    for act in (rng.random(7), np.zeros(4), np.array([2.0, 2.0, 1.0, 2.0])):
        np.testing.assert_array_equal(trs.activity_shares(act),
                                      jrs.activity_shares(act))
    for shares in (trs.traffic_shares(counts)[2], rng.random(11),
                   np.full(5, 0.2), rng.random(2)):
        for ladder in ((4, 8, 16), (16, 4), (8,), (4, 8, 16, 32)):
            got = trs.assign_rank_k(shares, ladder)
            np.testing.assert_array_equal(got,
                                          jrs.assign_rank_k(shares, ladder))
            order = np.argsort(-shares, kind="stable")
            assert all(got[a] >= got[b] for a, b in zip(order, order[1:]))
    assert trs.assign_rank_k(np.full(3, 1 / 3), (4, 8, 16)).tolist() == \
        [16, 8, 4]                                  # ties: by unit index
    with pytest.raises(ValueError, match="empty k ladder"):
        trs.assign_rank_k(np.ones(2), ())
    e, sh = rng.random((3, 6)), trs.traffic_shares(counts)
    np.testing.assert_array_equal(trs.traffic_weighted_energy(e, sh),
                                  jrs.traffic_weighted_energy(e, sh))
    names = ["blocks/g0/moe/w_gate[1][e2]", "tail/t0/moe/w_up[e0]",
             "blocks/g0/ssm/in_proj[1]", "tail/t0/mlp/w_down",
             "blocks/g0/attn/wq[0]", "enc_blocks/attn/wq[3]"]
    for name in names:
        assert ttargets._slice_key(name) == jtargets._slice_key(name)
    stats = dict(moe_counts={"blocks/g0/moe": counts,
                             "tail/t0/moe": counts[:1]},
                 scan_activity={"blocks/g0/ssm": np.array([1.0, 3.0])},
                 tokens=12)
    energies = {n: float(i + 1) for i, n in enumerate(names)}
    assert ttargets.traffic_weighted_unit_energies(
        energies, trs.RoutingStats(**stats)) == \
        jtargets.traffic_weighted_unit_energies(energies,
                                                jrs.RoutingStats(**stats))


def test_stats_round_trip_as_arrays():
    stats = trs.RoutingStats(moe_counts={"blocks/g0/moe": np.ones((2, 4))},
                             scan_activity={"tail/t0/ssm": np.array([0.5])},
                             tokens=64)
    arrays = stats.as_arrays()
    assert set(arrays) == {"moe:blocks/g0/moe", "scan:tail/t0/ssm", "tokens"}
    back = trs.RoutingStats.from_arrays(
        {k: torch.as_tensor(v) for k, v in arrays.items()})
    j = jrs.RoutingStats.from_arrays(arrays)
    assert back.tokens == j.tokens == 64
    for a, b in ((back.moe_counts, j.moe_counts),
                 (back.scan_activity, j.scan_activity)):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_calibration_batches_are_seeded():
    a = trs.calibration_batches(512, 2, 3, 8, seed=4)
    b = trs.calibration_batches(512, 2, 3, 8, seed=4)
    assert len(a) == 2 and all(x.shape == (3, 8) and x.dtype == np.int32
                               for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])
    assert not np.array_equal(a[0], trs.calibration_batches(512, 1, 3, 8,
                                                            seed=5)[0])
    assert 0 <= min(x.min() for x in a) and max(x.max() for x in a) < 512


def test_no_collector_no_event():
    assert trs.get_collector() is None
    seen = []
    with trs.collecting(lambda *a: seen.append(a)):
        assert trs.get_collector() is not None
    assert trs.get_collector() is None and not seen
    x = torch.tensor([[1.0, -2.0], [3.0, 0.5]])
    np.testing.assert_allclose(float(trs.mean_square(x)),
                               float(jnp.mean(jnp.square(jnp.asarray(t2n(x))))),
                               rtol=1e-7)


# ----------------------------------------------------------- calibration


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_matches_jax_on_injected_tokens(arch, monkeypatch):
    """`collect_lm_routing_stats` on the same tokens: the same event
    schedule (repeats, then pattern, then tail), equal kept-dispatch counts
    (shared experts add none), activity within float32 round-off."""
    jm = jbuild(jget(arch).scaled_down(compute_dtype="float32"))
    tm = tbuild(tget(arch).scaled_down(compute_dtype="float32"))
    assert trs.expected_units(tm) == jrs.expected_units(jm)
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    batches = trs.calibration_batches(jm.cfg.vocab, 2, 2, 16, seed=3)
    monkeypatch.setattr(jrs, "calibration_batches",
                        lambda *a, **kw: (jnp.asarray(b) for b in batches))
    js = jrs.collect_lm_routing_stats(jm, jp, batches=2, batch_size=2,
                                      seq_len=16)
    ts = trs.collect_lm_routing_stats(tm, tp, tokens=batches)
    assert ts.tokens == js.tokens == 64
    assert list(ts.moe_counts) == list(js.moe_counts)
    assert list(ts.scan_activity) == list(js.scan_activity)
    for k, v in js.moe_counts.items():
        np.testing.assert_array_equal(ts.moe_counts[k], v, err_msg=k)
        assert v.sum() <= 64 * tm.cfg.moe_top_k * tm.n_rep
    for k, v in js.scan_activity.items():
        np.testing.assert_allclose(ts.scan_activity[k], v, rtol=1e-5,
                                   err_msg=k)
    # the default batches are the seeded numpy draws of the config
    default = trs.collect_lm_routing_stats(tm, tp, batches=2, batch_size=2,
                                           seq_len=16, seed=3)
    for k, v in ts.moe_counts.items():
        np.testing.assert_array_equal(default.moe_counts[k], v)


def test_calibration_needs_routed_units():
    tm = tbuild(tget("olmo-1b").scaled_down())
    with pytest.raises(ValueError, match="no MoE or scan units"):
        trs.collect_lm_routing_stats(tm, {"embed": {"table": torch.zeros(1)}})


# ---------------------------------------------------------- stage boundary


@pytest.fixture(scope="module", params=sorted(KINDS))
def boundary(request, tmp_path_factory):
    """JAX's reduced routed pipeline: its profile plan saved, then its own
    energy_model, schedule and export; the port resuming the profile plan
    through export with the JAX package's LUT."""
    kind = request.param
    j_cfg, _, arch = KINDS[kind]
    base = tmp_path_factory.mktemp(f"routed_{kind}")
    pipe = JPipeline(j_cfg(arch))
    pipe.run_until("profile")
    pipe.plan.save(base / "profile")
    pipe.run_until("export")
    pipe.plan.save(base / "export")
    lut = torch.from_numpy(np.array(jelut.uniform_trace_lut()))
    orig = ttargets.uniform_trace_lut
    ttargets.uniform_trace_lut = lambda device="cpu": lut.to(device)
    try:
        tpipe = TPipeline.from_plan(TPlan.load(base / "profile"),
                                    device="cpu")
        tplan = tpipe.run_until("export")
    finally:
        ttargets.uniform_trace_lut = orig
    tplan.save(base / "port_export")
    return dict(kind=kind, jplan=pipe.plan, tplan=tplan, tpipe=tpipe,
                base=base)


def test_routed_decisions_match_jax(boundary):
    jplan, tplan = boundary["jplan"], boundary["tplan"]
    assert type(boundary["tpipe"].target).__name__ == \
        {"moe": "MoETarget", "scan": "ScanTarget"}[boundary["kind"]]
    jd, td = jplan.decisions, tplan.decisions
    assert [d["layer"] for d in td] == [d["layer"] for d in jd]
    routed = 0
    for a, b in zip(td, jd):
        assert a["k"] == b["k"], a["layer"]
        assert ("traffic_share" in a) == ("traffic_share" in b)
        if "traffic_share" in b:
            routed += 1
            assert a["traffic_share"] == b["traffic_share"], a["layer"]
        for key in ("energy_before", "energy_after", "share"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5,
                                       err_msg=f"{a['layer']} {key}")
    assert routed == tplan.metrics["routed_units"] \
        == jplan.metrics["routed_units"] > 0
    assert len({d["k"] for d in td if "traffic_share" in d}) > 1
    for key in ("energy_before", "energy_after", "energy_per_token"):
        np.testing.assert_allclose(tplan.metrics[key], jplan.metrics[key],
                                   rtol=1e-5, err_msg=key)
    assert tplan.metrics["energy_after"] < tplan.metrics["energy_before"]
    assert tplan.metrics["routing_tokens"] == jplan.metrics["routing_tokens"]


def test_routed_monotone_in_traffic(boundary):
    """Hot units gentler: within a layer (MoE) or a stack (scan), a larger
    traffic share never gets a smaller k."""
    groups = {}
    for d in boundary["tplan"].decisions:
        if "traffic_share" not in d:
            continue
        path, li, ei = ttargets._slice_key(d["layer"])
        key = (path, li) if ei is not None else path
        groups.setdefault(key, []).append((d["traffic_share"], d["k"]))
    assert groups
    for key, pts in groups.items():
        pts.sort()
        assert all(k0 <= k1 for (_, k0), (_, k1) in zip(pts, pts[1:])), key


def test_routed_artifacts_byte_identical(boundary):
    jarts, tarts = boundary["jplan"].artifacts, boundary["tplan"].artifacts
    assert list(tarts) == list(jarts) and tarts
    for name, a in tarts.items():
        for f in ART_FIELDS:
            np.testing.assert_array_equal(
                t2n(getattr(a, f)), np.asarray(getattr(jarts[name], f)),
                err_msg=f"{name}.{f}")
    assert boundary["tplan"].metrics["export_parity_max_rel_err"] < 1e-5


def test_port_plan_routing_reads_back_in_jax(boundary):
    """The port's plan carries ``stats["routing"]`` under the JAX keys; the
    JAX package loads it and recovers the same statistics (to its float32
    load of float64 leaves: rel 1e-7), and the port reads its own plan
    back equal."""
    jplan = JPlan.load(boundary["base"] / "port_export")
    js = jrs.RoutingStats.from_arrays(jplan.stats["routing"])
    ts = trs.RoutingStats.from_arrays(
        TPlan.load(boundary["base"] / "port_export").stats["routing"])
    want = jrs.RoutingStats.from_arrays(boundary["jplan"].stats["routing"])
    # JAX loads float64 leaves as float32 (x64 off), as for its own plans
    for got, rtol in ((js, 1e-7), (ts, 0)):
        assert got.tokens == want.tokens
        for a, b in ((got.moe_counts, want.moe_counts),
                     (got.scan_activity, want.scan_activity)):
            assert list(a) == list(b)
            for k in a:
                np.testing.assert_allclose(np.asarray(a[k]),
                                           np.asarray(b[k]), rtol=rtol,
                                           atol=0)


# ------------------------------------------------------------------- CLI


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cli_compress_routed_then_serve(kind, tmp_path):
    """``compress --target moe|scan --reduced --device cpu`` runs through
    export on its own calibration and saves the plan; ``serve --plan-in``
    serves it."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    base = tmp_path / kind
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "compress", "--target", kind,
         "--reduced", "--device", "cpu", "--plan-out", str(base)],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "routing calibration" in proc.stdout
    plan = TPlan.load(base)
    assert tuple(plan.completed) == ("profile", "energy_model", "schedule",
                                     "export")
    assert plan.config["target"]["kind"] == kind
    assert plan.metrics["routed_units"] > 0 and plan.artifacts
    assert "routing" in plan.stats
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "serve", "--plan-in",
         str(base), "--device", "cpu", "--quiet", "--requests", "2",
         "--new-tokens", "3"],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert '"serve_requests": 2' in proc.stdout
