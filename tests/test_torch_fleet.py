"""Port parity for multi-plan fleet serving (`repro_torch.serving.fleet`):
the plan registry, the router's configuration, levels and per-token
energies against the JAX package's, the route log of a burst-then-trickle
trace against the JAX router's entry for entry, budget routing, the
per-plan and per-tenant accounting, routed == pinned tokens in engine and
oneshot modes, and ``serve --plans`` / ``--plans-dir`` through the port's
CLI (reduced olmo-1b, the JAX fleet tests' engine and router settings).

Tolerances: per-token energies rel 1e-6 (the same integer weight counts
priced with the same uniform-trace LUT, float32 sums in another order);
everything else is exact. The route log is a function of the submit
sequence and the engines' pending counts only, so both routers must log
the same plan, level and pressure for every request. Served tokens are
never compared with the JAX package's engine on a compressed plan (its
activation scale is one a call; the port's engine takes one a token).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import energy_lut as jelut
from repro.models.lm import build_lm as jbuild
from repro.nn.spec import init_params as jinit
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import FleetRouter as JFleetRouter
from repro.serving import PlanHandle as JPlanHandle
from repro.serving import RouterConfig as JRouterConfig
from repro.serving import ServeRequest as JServeRequest
from repro_torch.configs import get_config as tget
from repro_torch.models.lm import build_lm as tbuild
from repro_torch.nn.spec import params_from_numpy
from repro_torch.pipeline import cli
from repro_torch.pipeline.config import parse_plan_spec
from repro_torch.pipeline.config import reduced_lm_config as t_reduced_lm
from repro_torch.pipeline.pipeline import Pipeline as TPipeline
from repro_torch.pipeline.plan import CompressionPlan as TPlan
from repro_torch.serving import metrics as tmetrics
from repro_torch.serving import (
    EngineConfig,
    FleetRouter,
    PlanHandle,
    PlanRegistry,
    RequestBudget,
    RouterConfig,
    ServeRequest,
    ServingEngine,
)

ENGINE = dict(max_batch=2, prompt_buckets=(8,), new_token_buckets=(4,),
              max_waves=2)
CFG = EngineConfig(**ENGINE)
# capacity 4 slots: small bursts cross the watermark (the JAX fleet tests'
# settings)
ROUTER = dict(high_watermark=0.5, low_watermark=0.25, hysteresis=2)
SHAPES = [(6, 4), (8, 4)]
BURST, TRICKLE = 10, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work in this file runs on one thread: beside the
    suite's parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    """(JAX model, port model, JAX params, port params)."""
    jm = jbuild(jget("olmo-1b").scaled_down(compute_dtype="float32"))
    tm = tbuild(tget("olmo-1b").scaled_down(compute_dtype="float32"))
    jp = jinit(jax.random.PRNGKey(0), jm.spec)
    return jm, tm, jp, params_from_numpy(jax.device_get(jp), "cpu")


def _handles(tm):
    return [PlanHandle.uncompressed(),
            PlanHandle.from_compress_k(tm, 8, device="cpu"),
            PlanHandle.from_compress_k(tm, 4, device="cpu")]


def _prompt(vocab, plen, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=plen).astype(np.int32)


def _trace(vocab):
    """(burst, trickle) prompts: two tenants in the burst."""
    burst = [(_prompt(vocab, 6, i), f"tenant{i % 2}") for i in range(BURST)]
    trickle = [(_prompt(vocab, 6 + (i % 3) // 2, 20 + i), "tenant0")
               for i in range(TRICKLE)]
    return burst, trickle


def _drive(fleet, make_request, vocab):
    """Burst (submitted back to back, then drained), then a trickle (each
    request drained before the next); returns the fleet's results."""
    burst, trickle = _trace(vocab)
    rids = [fleet.submit(make_request(p, t)) for p, t in burst]
    out = fleet.run()
    for p, t in trickle:
        rids.append(fleet.submit(make_request(p, t)))
        out = fleet.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def driven(lm):
    """The port's fleet and the JAX package's, each driven through the
    same trace: (port fleet, port results, JAX fleet)."""
    jm, tm, jp, tp = lm
    # the JAX package's uniform-trace LUT (the two packages' Monte-Carlo
    # draws differ), so the handles' energies are comparable
    lut = torch.from_numpy(np.array(jelut.uniform_trace_lut()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmetrics, "uniform_trace_lut",
                   lambda device="cpu": lut.to(device))
        fleet = FleetRouter(tm, tp, _handles(tm), config=CFG,
                            router=RouterConfig(**ROUTER), device="cpu")
    fleet.warmup(SHAPES)
    results = _drive(fleet, lambda p, t: ServeRequest(
        tokens=p, max_new_tokens=4, tenant=t), tm.cfg.vocab)
    jfleet = JFleetRouter(jm, jp, [JPlanHandle.uncompressed(),
                                   JPlanHandle.from_compress_k(jm, 8),
                                   JPlanHandle.from_compress_k(jm, 4)],
                          config=JEngineConfig(**ENGINE),
                          router=JRouterConfig(**ROUTER))
    _drive(jfleet, lambda p, t: JServeRequest(
        tokens=p, max_new_tokens=4, tenant=t), jm.cfg.vocab)
    return fleet, results, jfleet


# --------------------------------------------------------------- registry


def test_registry_dedupes_by_content_and_guards_ids(lm):
    _, tm, _, _ = lm
    k4 = PlanHandle.from_compress_k(tm, 4, device="cpu")
    reg = PlanRegistry([PlanHandle.uncompressed(), k4])
    again = reg.register(PlanHandle.from_compress_k(tm, 4, plan_id="k4-copy",
                                                    device="cpu"))
    assert again is k4
    assert len(reg) == 2 and "k4-copy" not in reg
    with pytest.raises(ValueError, match="already registered"):
        reg.register(PlanHandle.from_compress_k(tm, 8, plan_id="k4",
                                                device="cpu"))
    with pytest.raises(KeyError):
        reg.get("missing")
    assert reg.get("k4") is k4 and [h.plan_id for h in reg] == ["base", "k4"]


def test_registry_from_dir_and_its_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        PlanRegistry.from_dir(tmp_path / "nope")
    with pytest.raises(ValueError, match="no CompressionPlan"):
        PlanRegistry.from_dir(tmp_path)
    # plans by file stem; a JSON without its npz is skipped
    for k in (4, 8):
        TPipeline(t_reduced_lm("olmo-1b", compress_k=k),
                  device="cpu").run_until("schedule").save(
            tmp_path / f"olmo-k{k}")
    (tmp_path / "stray.json").write_text("{}")
    reg = PlanRegistry.from_dir(tmp_path, include_uncompressed=True)
    assert sorted(h.plan_id for h in reg) == ["base", "olmo-k4", "olmo-k8"]
    assert reg.get("olmo-k4").compress_k == 4
    assert reg.get("olmo-k8").energy_per_token \
        > reg.get("olmo-k4").energy_per_token > 0


def test_router_config_validation_and_plan_specs():
    with pytest.raises(ValueError):
        RouterConfig(high_watermark=0.2, low_watermark=0.5)
    with pytest.raises(ValueError):
        RouterConfig(hysteresis=0)
    with pytest.raises(ValueError):
        RouterConfig(low_watermark=-0.1)
    assert parse_plan_spec("base") == (0, 0)
    assert parse_plan_spec("k8") == (8, 0)
    assert parse_plan_spec("k4m2") == (4, 2)
    assert parse_plan_spec("plans/olmo-k4") == (None, 0)


def test_fleet_over_a_request_mesh_routes_as_without(lm, driven):
    """A fleet over a 2-shard CPU request mesh hands it to every engine,
    then routes and serves the trace as the fleet without one does (route
    log and tokens equal)."""
    from repro_torch.distributed import request_mesh

    _, tm, _, tp = lm
    fleet, results, _ = driven
    lut = torch.from_numpy(np.array(jelut.uniform_trace_lut()))
    mesh = request_mesh(["cpu", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmetrics, "uniform_trace_lut",
                   lambda device="cpu": lut.to(device))
        meshed = FleetRouter(tm, tp, _handles(tm), config=CFG,
                             router=RouterConfig(**ROUTER), mesh=mesh,
                             device="cpu")
    assert all(e.mesh is mesh for e in meshed.engines.values())
    meshed.warmup(SHAPES)
    got = _drive(meshed, lambda p, t: ServeRequest(
        tokens=p, max_new_tokens=4, tenant=t), tm.cfg.vocab)
    assert meshed.route_log == fleet.route_log[:BURST + TRICKLE]
    assert [r.tokens for r in got] == [r.tokens for r in results]


# ---------------------------------------------------------------- routing


def test_levels_and_energies_match_jax(driven):
    fleet, _, jfleet = driven
    assert [h.plan_id for h in fleet.levels] == ["base", "k8", "k4"]
    assert [h.plan_id for h in fleet.levels] \
        == [h.plan_id for h in jfleet.levels]
    for t, j in zip(fleet.levels, jfleet.levels):
        assert t.fingerprint == j.fingerprint
        np.testing.assert_allclose(t.energy_per_token, j.energy_per_token,
                                   rtol=1e-6)


def test_route_log_matches_jax(driven):
    fleet, results, jfleet = driven
    assert len(fleet.route_log) == len(jfleet.route_log) == BURST + TRICKLE
    for t, j in zip(fleet.route_log, jfleet.route_log):
        assert t == j
    levels = [e["level"] for e in fleet.route_log]
    burst, trickle = levels[:BURST], levels[BURST:]
    # the burst only degrades (never flaps back), to the last level
    assert burst == sorted(burst) and burst[0] == 0 and burst[-1] == 2
    change_at = [i for i in range(1, BURST) if burst[i] != burst[i - 1]]
    assert all(b - a >= ROUTER["hysteresis"]
               for a, b in zip(change_at, change_at[1:]))
    # the trickle recovers to level 0, again through the hysteresis
    assert trickle == sorted(trickle, reverse=True) and trickle[-1] == 0
    rep = fleet.report()
    assert rep["level_degrades"] == 2 and rep["level_recovers"] == 2
    assert all(len(r.tokens) == 4 for r in results)


def test_budget_routed_not_rejected(lm, driven):
    fleet, _, _ = driven
    _, tm, _, _ = lm
    lo = float(fleet.levels[-1].energy_per_token)
    hi = float(fleet.levels[-2].energy_per_token)
    rid = fleet.submit(ServeRequest(
        tokens=_prompt(tm.cfg.vocab, 6, 40), max_new_tokens=4,
        budget=RequestBudget(energy_eu_per_token=(lo + hi) / 2)))
    assert fleet.route_log[-1]["plan_id"] == fleet.levels[-1].plan_id
    assert fleet.route_log[-1]["budget_miss"] is False
    rid2 = fleet.submit(ServeRequest(
        tokens=_prompt(tm.cfg.vocab, 6, 41), max_new_tokens=4,
        budget=RequestBudget(energy_eu_per_token=lo * 0.5)))
    assert fleet.route_log[-1]["plan_id"] == fleet.levels[-1].plan_id
    assert fleet.route_log[-1]["budget_miss"] is True
    out = fleet.run()
    assert len(out[rid].tokens) == 4 and len(out[rid2].tokens) == 4
    rep = fleet.report()
    assert rep["slo_total"] == 2 and rep["slo_hits"] == 1


def test_tenant_and_plan_accounting_sum_to_totals(driven):
    fleet, _, _ = driven
    rep = fleet.report()
    assert rep["requests"] == len(fleet.route_log)
    for part in ("tenants", "plans"):
        assert sum(t["requests"] for t in rep[part].values()) \
            == rep["requests"]
        assert sum(t["new_tokens"] for t in rep[part].values()) \
            == rep["new_tokens"]
        assert sum(t["energy_eu"] for t in rep[part].values()) \
            == pytest.approx(rep["energy_eu_total"], rel=1e-6)
    routed = {pid: sum(1 for e in fleet.route_log if e["plan_id"] == pid)
              for pid in fleet.engines}
    assert {pid: p["requests"] for pid, p in rep["plans"].items()} == routed
    assert rep["plans_resident"] == 3
    assert rep["recompiles_after_warmup"] == 0


# ------------------------------------------------------- routed == pinned


@pytest.mark.parametrize("mode", ["engine", "oneshot"])
def test_routed_matches_pinned_per_plan(lm, mode):
    """Routing picks *which* plan serves a request, never what that plan
    outputs: an engine pinned to the routed plan gives the same tokens. In
    engine mode too, since the port's engine rows are batch-invariant."""
    _, tm, _, tp = lm
    handles = [PlanHandle.uncompressed(),
               PlanHandle.from_compress_k(tm, 4, device="cpu")]
    fleet = FleetRouter(tm, tp, handles, mode=mode, config=CFG,
                        router=RouterConfig(high_watermark=0.3,
                                            low_watermark=0.1, hysteresis=1),
                        device="cpu")
    fleet.warmup(SHAPES)
    reqs = [ServeRequest(tokens=_prompt(tm.cfg.vocab, 5 + i % 3, 30 + i),
                         max_new_tokens=4) for i in range(6)]
    routed = fleet.serve(reqs)
    plans = [e["plan_id"] for e in fleet.route_log]
    assert len(set(plans)) == 2, f"trace routed to one plan only: {plans}"
    for h in handles:
        eng = ServingEngine(tm, tp, mode=mode, config=CFG, plan=h,
                            device="cpu")
        mine = [i for i, pid in enumerate(plans) if pid == h.plan_id]
        pinned = eng.serve([reqs[i] for i in mine])
        for i, res in zip(mine, pinned):
            assert list(routed[i].tokens) == list(res.tokens)


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("source", ["plans", "plans_dir"])
def test_cli_serves_a_fleet(tmp_path, capsys, source):
    base = tmp_path / "olmo"
    TPipeline(t_reduced_lm("olmo-1b"), device="cpu").run_until(
        "export").save(base)
    if source == "plans":
        extra = ["--plans", "k4", "base"]
        want = {"k4", "base"}
    else:
        plans = tmp_path / "plans"
        plans.mkdir()
        TPipeline(t_reduced_lm("olmo-1b", compress_k=8),
                  device="cpu").run_until("schedule").save(plans / "olmo-k8")
        extra = ["--plans-dir", str(plans)]
        want = {"olmo-k8"}
    out = tmp_path / "served"
    assert cli.main(["serve", "--plan-in", str(base), "--device", "cpu",
                     "--requests", "4", "--plan-out", str(out),
                     *extra]) == 0
    printed = capsys.readouterr().out
    assert "[pipeline] fleet: 4 requests" in printed
    m = TPlan.load(out).metrics
    assert m["serve_mode"] == "fleet"
    assert set(m["serve_plans"].split(",")) == want
    assert m["serve_requests"] == 4
    assert m["serve_recompiles_after_warmup"] == 0
