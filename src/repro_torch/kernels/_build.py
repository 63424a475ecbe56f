"""Build a kernel's CUDA source into a plain-C shared library and load it.

Every kernel of the port is one ``csrc/*.cu`` file with ``extern "C"`` entry
points. `KernelLibrary` compiles it at first use with ``nvcc`` for ``sm_90a``
into ``build/<name>/`` at the repository root (named by a hash of the source
and flags, so an edit rebuilds) and loads it with `ctypes`. Nothing here runs
at import: the CPU tests import the kernel modules on hosts without ``nvcc``
or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's kernels are "
            "built from source at first use and need the CUDA toolkit")
    return str(path)


class KernelLibrary:
    """One CUDA source, built at first use into ``build/<name>/``.

    ``functions`` maps each ``extern "C"`` entry point to its ctypes argument
    types (``c_void_p`` for pointers and streams, ``c_int`` for ints); every
    entry point returns a CUDA error code as ``int``. ``build_log`` holds
    nvcc's output (ptxas ``-v`` resource lines) of a build done by this
    process."""

    def __init__(self, name: str, source: Path,
                 functions: Dict[str, Sequence]):
        self.name = name
        self.source = source
        self.functions = dict(functions)
        self.build_dir = BUILD_ROOT / name
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    def library_path(self) -> Path:
        tag = hashlib.sha256(self.source.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return self.build_dir / f"lib{self.name}_{tag}.so"

    def build(self) -> Path:
        """Compile unless this source's library already exists; returns the
        library path. Raises `RuntimeError` with nvcc's output on failure."""
        out = self.library_path()
        if out.exists():
            return out
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
        self.build_log = proc.stdout + proc.stderr
        return out

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for fn_name, argtypes in self.functions.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib
