"""The port stands alone: `repro_torch` and ``chip_smoke.py`` import neither
JAX nor the JAX package, and the entry points refuse to run on a device that
is not there instead of quietly switching to the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# the modules the baselines and the encoder-decoder family added or changed
BASELINES_AND_ENCDEC = ("core/baselines.py", "core/mac_model.py",
                        "core/grouping.py", "core/lm_compress.py",
                        "nn/attention.py", "nn/transformer.py",
                        "models/lm.py", "launch/train.py",
                        "serving/engine.py", "pipeline/targets.py")


# the modules the routed targets added or changed
ROUTED = ("core/routing_stats.py", "nn/moe.py", "nn/ssm.py", "nn/rglru.py",
          "kernels/fake_quant/ops.py")


# the modules the VLM prefix and the cosim gate added or changed
VLM_AND_COSIM = ("cosim/__init__.py", "cosim/pe.py", "cosim/systolic.py",
                 "cosim/verify.py", "core/profiler.py",
                 "kernels/transition_energy/ops.py", "pipeline/cli.py")


# the modules the 1-D meshes, the resilient loop and gradient compression
# added
MESH_AND_FAULT = ("distributed/__init__.py", "distributed/sharding.py",
                  "distributed/fault.py", "optim/compression.py")


# the modules the 2-D meshes (rules, elastic restore, the dry run, the
# meshed steps) added or changed
MESH2D = ("distributed/elastic.py", "distributed/spawn.py",
          "launch/mesh.py", "launch/dryrun.py", "checkpoint/manager.py",
          "optim/optimizers.py", "core/qat.py")


# the modules K2's configuration tuner added or changed
AUTOTUNE = ("kernels/lut_matmul/autotune.py", "kernels/lut_matmul/lut_matmul.py",
            "kernels/lut_matmul/ops.py", "serving/bucketing.py")


@pytest.mark.parametrize("rel", BASELINES_AND_ENCDEC + ROUTED + VLM_AND_COSIM
                         + MESH_AND_FAULT + MESH2D + AUTOTUNE)
def test_new_modules_are_checked_and_a_stray_import_fails(rel, tmp_path):
    """Each module is among the files the import check walks, imports
    cleanly alone, and the check catches a stray ``import jax`` or ``from
    repro...`` added to it."""
    path = PORT / rel
    assert path in FILES
    assert not {r for r in _imported_roots(path) if r in FORBIDDEN}
    for stray in ("import jax.numpy as jnp\n",
                  "from repro.core import qat\n"):
        bad = tmp_path / path.name
        bad.write_text(stray + path.read_text())
        assert {r for r in _imported_roots(bad) if r in FORBIDDEN}
    mod = "repro_torch." + rel[:-3].replace("/", ".")
    code = (f"import sys, {mod}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr


COSIM_INDEPENDENT_OF = ("repro_torch.core.bitops", "repro_torch.core.grouping",
                       "repro_torch.core.mac_model", "repro_torch.kernels")


def _imported_modules(path: Path):
    """Every module a file names in an import (``from a import b`` names
    ``a`` and ``a.b``)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{alias.name}" for alias in node.names)


def test_cosim_shares_no_code_with_the_kernel_it_gates(tmp_path):
    """The cosim's independence contract: no module of `repro_torch.cosim`
    imports K1, its plain version or their bit helpers (`core.bitops`,
    `core.grouping`, `core.mac_model`, `repro_torch.kernels`); the check
    catches such an import added to one."""
    files = sorted((PORT / "cosim").glob("*.py"))
    assert {f.name for f in files} >= {"pe.py", "systolic.py", "verify.py"}

    def shared(path):
        return sorted(m for m in _imported_modules(path)
                      if m.startswith(COSIM_INDEPENDENT_OF))

    for path in files:
        assert not shared(path), f"{path.relative_to(ROOT)} imports " \
            f"{shared(path)}"
    for stray in ("from repro_torch.core.bitops import popcount\n",
                  "from repro_torch.core import grouping\n",
                  "import repro_torch.kernels.transition_energy.ref\n"):
        bad = tmp_path / "pe.py"
        bad.write_text(stray + (PORT / "cosim" / "pe.py").read_text())
        assert shared(bad)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cli_without_device_flag_needs_cuda(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "serve", "--plan-in",
         str(tmp_path / "missing")], capture_output=True, text=True,
        env=_env(), cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert "cuda" in proc.stderr.lower() and "--device cpu" in proc.stderr


def test_pipeline_refuses_missing_cuda():
    import torch

    from repro_torch.pipeline.config import PipelineConfig
    from repro_torch.pipeline.pipeline import Pipeline

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal cannot be shown here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline(PipelineConfig())


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Run from the repository on a host without CUDA, and alone in an
    otherwise empty directory, the on-card check exits non-zero and prints
    no result line."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script in (ROOT / "chip_smoke.py", lone):
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True,
                              cwd=script.parent, timeout=300,
                              env={k: v for k, v in os.environ.items()
                                   if k != "PYTHONPATH"})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
