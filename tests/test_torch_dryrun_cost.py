"""The dry run's per-device FLOPs and collectives (`repro_torch.launch.dryrun
.step_costs`) against the JAX package's compiled step, and the step knobs'
effect on them.

A reduced olmo-1b train cell (8 x 64 tokens, 16-position attention blocks,
float32) on a (4, 2) ("data", "model") mesh: JAX compiles its meshed
`make_train_step` on eight host CPU devices in a subprocess (as
`tests/test_torch_sharding_rules.py` gets JAX's device order) and
`repro.launch.hlo_cost.loop_corrected_cost` counts each device's dot FLOPs.
The port's dry-run ``flops`` hold to it within 2%, on the tensor-parallel
layout and on the storage-only one, with one product left out by name: the
recompute of each checkpointed layer's last product (the FFN's w_down),
whose output no gradient reads, so XLA drops it while the port's
recompute runs it (``flops["remat_tail"]``). A reduced phi3.5-moe cell in
the same subprocess, compiled with ``moe_local_dispatch=True`` (the
dispatch buffer's experts over "model"), holds the port's expert-parallel
count to JAX's the same way. Reduced mamba2-1.3b, recurrentgemma-2b and
whisper-large-v3 on the same mesh, compiled in a second subprocess started
beside the first: their recurrent mixers, encoder blocks and
cross-attention split over "model", held to JAX the same way once two
named terms are taken into account: ``remat_tail`` counts only the last
product of each checkpointed pattern repeat (JAX checkpoints a repeat of
recurrentgemma's (rglru, rglru, local), not each layer) and the unstacked
tail's whole recompute (JAX runs the tail unchecked), and
``flops["xla_only"]`` adds the SSD products JAX runs and the port does
not (its C B^T scores a head where the port's are a group; two decay
gradients XLA writes as products).
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun as D
from repro_torch.launch import train as T
from repro_torch.models.lm import build_lm

ROWS, SEQ, BLOCK = 8, 64, 16
STORAGE_ONLY = dict(heads=None, mlp=None, vocab=None, kv_heads=None)
MESH = S.AbstractMesh((4, 2), ("data", "model"))
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
FLOPS_RTOL = 0.02

_JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import Shape, get_config
from repro.distributed.sharding import DEFAULT_RULES
from repro.launch import train as TR
from repro.launch.hlo_cost import loop_corrected_cost
from repro.models.lm import build_lm

rows, seq, block, storage, moe_arch = json.loads(sys.argv[1])
mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
out = []
for arch, rules, local in (
        ("olmo-1b", DEFAULT_RULES, False),
        ("olmo-1b", DEFAULT_RULES.replace(**storage), False),
        (moe_arch, DEFAULT_RULES, True)):
    cfg = get_config(arch).scaled_down(compute_dtype="float32")
    model = build_lm(cfg)
    step_cfg = TR.StepConfig(q_block=block, kv_block=block)
    specs = TR.batch_specs(cfg, Shape("cell", "train", seq, rows))
    step = TR.make_train_step(model, step_cfg, mesh, rules,
                              moe_local_dispatch=local)
    jitted = jax.jit(step, in_shardings=(
        TR.train_state_shardings(model, mesh, rules),
        TR.batch_shardings(specs, mesh, rules),
        TR.comp_shardings(model, mesh, rules)))
    with mesh:
        hlo = jitted.lower(TR.abstract_train_state(model), specs,
                           TR.comp_abstract(model)).compile().as_text()
    out.append(loop_corrected_cost(hlo)["flops"])
print(json.dumps(out))
"""


def model(arch="olmo-1b"):
    return build_lm(get_config(arch).scaled_down(compute_dtype="float32"))


def costs(rules=S.DEFAULT_RULES, arch="olmo-1b", **step):
    cfg = T.StepConfig(**dict(dict(q_block=BLOCK, kv_block=BLOCK), **step))
    return D.step_costs(model(arch), MESH, rules, "train", ROWS, SEQ, cfg)


# the recurrent mixers and the encoder-decoder, split over "model" on the
# (4, 2) mesh, compiled in a second subprocess beside the first
SPLIT_ARCHS = ("mamba2-1.3b", "recurrentgemma-2b", "whisper-large-v3")
_JAX_SPLIT_SCRIPT = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import Shape, get_config
from repro.distributed.sharding import DEFAULT_RULES
from repro.launch import train as TR
from repro.launch.hlo_cost import loop_corrected_cost
from repro.models.lm import build_lm

rows, seq, block, archs = json.loads(sys.argv[1])
mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
out = []
for arch in archs:
    cfg = get_config(arch).scaled_down(compute_dtype="float32")
    model = build_lm(cfg)
    step_cfg = TR.StepConfig(q_block=block, kv_block=block)
    specs = TR.batch_specs(cfg, Shape("cell", "train", seq, rows))
    step = TR.make_train_step(model, step_cfg, mesh, DEFAULT_RULES)
    jitted = jax.jit(step, in_shardings=(
        TR.train_state_shardings(model, mesh, DEFAULT_RULES),
        TR.batch_shardings(specs, mesh, DEFAULT_RULES),
        TR.comp_shardings(model, mesh, DEFAULT_RULES)))
    with mesh:
        hlo = jitted.lower(TR.abstract_train_state(model), specs,
                           TR.comp_abstract(model)).compile().as_text()
    out.append(loop_corrected_cost(hlo)["flops"])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_compiles():
    """Both JAX subprocesses, started together (each with its own
    timeout): the olmo-1b and phi3.5-moe cells, and the split archs'."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, json.dumps(arg)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for script, arg in (
            (_JAX_SCRIPT, [ROWS, SEQ, BLOCK, STORAGE_ONLY, MOE_ARCH]),
            (_JAX_SPLIT_SCRIPT, [ROWS, SEQ, BLOCK, list(SPLIT_ARCHS)]))]
    yield procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _result(proc, timeout):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_flops(jax_compiles):
    return _result(jax_compiles[0], 120)


@pytest.fixture(scope="module")
def jax_split_flops(jax_compiles):
    return dict(zip(SPLIT_ARCHS, _result(jax_compiles[1], 120)))


@pytest.mark.parametrize("layout", ["tensor_parallel", "storage_only",
                                    "expert_parallel"])
def test_dryrun_flops_match_jax_loop_corrected(jax_flops, layout):
    rules = S.DEFAULT_RULES.replace(**STORAGE_ONLY) \
        if layout == "storage_only" else S.DEFAULT_RULES
    want = jax_flops[["tensor_parallel", "storage_only",
                      "expert_parallel"].index(layout)]
    if layout == "expert_parallel":
        # phi3.5-moe: a device runs 2 of the 8 rows on 2 of the 4 experts
        flops = costs(rules, MOE_ARCH)["flops"]
        alone = D.step_costs(model(MOE_ARCH), S.AbstractMesh(
            (1, 1), ("data", "model")), rules, "train", ROWS, SEQ,
            T.StepConfig(q_block=BLOCK, kv_block=BLOCK))["flops"]
        assert flops["by_unit"]["moe"] * 8 == alone["by_unit"]["moe"]
    else:
        flops = costs(rules)["flops"]
        assert flops["remat_tail"] > 0
    got = flops["total"] - flops["remat_tail"] + flops["xla_only"]
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)


@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_split_units_flops_match_jax_loop_corrected(jax_split_flops, arch):
    """The recurrent mixers, whisper's encoder blocks and its
    cross-attention split over "model" as the JAX partitioner divides
    them: a device's dry-run FLOPs on (4, 2), less `remat_tail` (the last
    product of each checkpointed pattern repeat, XLA's remat drops it) and
    plus `xla_only` (mamba2's SSD: C B^T a head where the port's is a
    group, and two decay gradients XLA runs as products), equal JAX's
    loop-corrected count within 2%; a device runs an eighth of the 1 x 1
    step, but for mamba2's scores, which each model rank repeats."""
    want = jax_split_flops[arch]
    flops = costs(arch=arch)["flops"]
    got = flops["total"] - flops["remat_tail"] + flops["xla_only"]
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)
    alone = D.step_costs(model(arch), S.AbstractMesh((1, 1), ("data",
                                                              "model")),
                         None, "train", ROWS, SEQ,
                         T.StepConfig(q_block=BLOCK, kv_block=BLOCK))["flops"]
    split = {"mamba2-1.3b": ("readout",),
             "recurrentgemma-2b": ("attention", "ffn", "mixer", "readout"),
             "whisper-large-v3": ("attention", "ffn", "projections",
                                  "readout")}[arch]
    for unit in split:
        assert flops["by_unit"][unit] * 8 == alone["by_unit"][unit], unit
    assert (flops["xla_only"] > 0) == (arch == "mamba2-1.3b")


def test_no_remat_lowers_flops():
    with_remat, without = costs()["flops"], costs(remat=False)["flops"]
    assert without["total"] < with_remat["total"]
    assert without["remat_tail"] == 0
    # every layer's forward products once fewer; the read-out unchanged
    assert without["by_unit"]["readout"] == with_remat["by_unit"]["readout"]


def test_grad_accum_keeps_flops_and_doubles_the_step_collectives():
    one, two = costs(), costs(grad_accum=2)
    assert two["flops"] == one["flops"]
    assert two["collectives"]["all-gather"]["count"] == \
        2 * one["collectives"]["all-gather"]["count"]


def test_storage_only_rules_double_the_dense_units_flops():
    tp = costs()["flops"]["by_unit"]
    whole = costs(S.DEFAULT_RULES.replace(**STORAGE_ONLY))["flops"]["by_unit"]
    assert set(tp) == {"attention", "ffn", "projections", "readout"}
    for unit in tp:
        assert whole[unit] == 2 * tp[unit], unit


def test_qat_and_flash_change_what_they_should():
    base = costs()
    no_qat = costs(qat=False)
    assert no_qat["flops"] == base["flops"]
    # no K3 scales' MAX, no activation amax, the tensor-parallel sums in
    # float32 instead of float64
    assert no_qat["collectives"]["all-reduce"]["bytes"] \
        < base["collectives"]["all-reduce"]["bytes"]
    flash = costs(flash=True)["flops"]["by_unit"]
    assert flash["attention"] * 8 == base["flops"]["by_unit"]["attention"] \
        * 9        # the backward's five tile products against four


def test_kv_seq_cache_layout_gathers_its_sequence():
    m = build_lm(get_config("olmo-1b"))
    mesh = S.AbstractMesh((32, 8), ("data", "model"))
    heads = D.step_costs(m, mesh, None, "decode", 128, 32768)
    seq = D.step_costs(m, mesh, None, "decode", 128, 32768,
                       kv_seq_shard=True)
    assert heads["flops"] == seq["flops"]
    assert seq["collectives"]["all-gather"]["bytes"] \
        > heads["collectives"]["all-gather"]["bytes"]


def test_cli_flags_reach_the_manifest(tmp_path):
    assert D.main(["--arch", "olmo-1b", "--shape", "train_4k", "--no-remat",
                   "--grad-accum", "2", "--rules",
                   "heads=None,mlp=None,vocab=None,kv_heads=None",
                   "--tag", "whole", "--out-dir", str(tmp_path)]) == 0
    cell = json.loads((tmp_path / "olmo-1b__train_4k__32x8__whole.json")
                      .read_text())
    assert (cell["remat"], cell["grad_accum"], cell["tag"]) == (False, 2,
                                                              "whole")
    assert cell["rules_override"] == STORAGE_ONLY
    assert cell["flops"]["remat_tail"] == 0
    assert cell["hlo_only"]["fields"] == ["temp_size_in_bytes"]
    assert D.parse_rules("embed=data+model,heads=None") == {
        "embed": ("data", "model"), "heads": None}


@pytest.mark.parametrize("flag", ["--remat-save-qat"])
def test_cli_refuses_knobs_that_change_no_count(tmp_path, capsys, flag):
    """The activations' bytes are not counted yet: the flag is refused,
    not recorded as if it were."""
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "phi3.5-moe-42b-a6.6b", "--shape", "train_4k",
                flag, "--out-dir", str(tmp_path)])
    assert e.value.code == 2
    assert flag in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_qwen_train_gathers_a_sixth_of_the_storage_only_layout():
    tp = D.run_cell("qwen2.5-14b", "train_4k", False)
    whole = D.run_cell("qwen2.5-14b", "train_4k", False,
                       rules_override=STORAGE_ONLY)
    assert tp["gathered_peak_bytes"] * 6 <= whole["gathered_peak_bytes"]
    assert tp["flops"]["total"] < whole["flops"]["total"]


def test_cli_moe_local_writes_its_manifest(tmp_path):
    """``python -m repro_torch.launch.dryrun --moe-local`` records the
    local dispatch; the counts are the step's without it (the port's
    dispatch is local either way), and the experts split: a device of
    phi3.5-moe's train_4k on 32 x 8 gathers an eighth of their bytes."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [
               os.path.join(os.path.dirname(__file__), "..", "src"),
               os.environ.get("PYTHONPATH")]))}
    subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         MOE_ARCH, "--shape", "train_4k", "--moe-local", "--tag", "local",
         "--out-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    cell = json.loads((tmp_path / f"{MOE_ARCH}__train_4k__32x8__local.json")
                      .read_text())
    assert cell["status"] == "ok" and cell["moe_local_dispatch"] is True
    plain = D.run_cell(MOE_ARCH, "train_4k", False)
    assert plain["moe_local_dispatch"] is False
    for key in ("flops", "collectives", "gathered_peak_bytes"):
        assert cell[key] == plain[key], key
    whole = D.run_cell(MOE_ARCH, "train_4k", False,
                       rules_override={"expert": None})
    assert cell["gathered_peak_bytes"] * 6 < whole["gathered_peak_bytes"]
