"""Atomic, asynchronous checkpoints of tensor trees (port of
`repro.checkpoint.manager`), in the JAX package's layout:

  * a checkpoint is a directory ``step_<N:08d>/`` holding npz shards of at
    most 512 MB (leaves copied to host numpy, names with ``/`` written as
    ``::``) and ``manifest.json`` (flat name -> shard, shape, dtype);
  * writes go to ``step_<N>.tmp`` and are renamed into place, then the
    ``latest`` pointer file is replaced the same way, so a crash mid-save
    never corrupts the restore path;
  * saves run on a background thread (``wait()`` joins) from a snapshot
    copied to the host at ``save`` time, so training may go on updating
    the tensors, in place or not;
  * ``keep`` bounds the retained checkpoints (the oldest pruned after a
    successful save).

A checkpoint written by either package restores in the other: a bfloat16
leaf is stored as its raw 16-bit words under the manifest's dtype string
``"bfloat16"`` (what numpy writes for the JAX package's bfloat16 arrays),
and `restore` reads those words back as `torch.bfloat16`. ``restore``
places every leaf on one device, or with ``shardings`` (a tree of
`repro_torch.distributed.sharding.NamedSharding`) keeps each rank's own
slice of every host array on its mesh's device: host arrays make restores
elastic, any later mesh can take them
(`repro_torch.distributed.elastic`). A sharded state is saved whole:
`gather_tree` it, and let one rank save.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE, resolve_device
from repro_torch.nn.spec import flatten_with_names

_SHARD_BYTES = 512 * 1024 * 1024  # max npz shard size
_RAW16 = np.dtype("V2")            # numpy's view of a bfloat16 word


def _unflatten(flat: Dict[str, Any]) -> Any:
    tree: Dict[str, Any] = {}
    for name, leaf in flat.items():
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy of ``leaf`` as numpy, its manifest dtype string)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_RAW16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def _tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        words = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(words).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------------------------------------------------------------- save

    def save(self, step: int, state: Any, *, block: bool = False) -> None:
        """Snapshot ``state`` (a nested dict of tensors or arrays) at
        ``step``. Every leaf is copied to the host before the background
        write starts."""
        self.wait()
        host = {name: _host(v)
                for name, v in flatten_with_names(state).items()}

        def _write():
            try:
                self._write_sync(step, host)
            except BaseException as e:  # surfaced on next wait()/save()
                self._error = e

        if self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def _write_sync(self, step: int,
                    host: Dict[str, Tuple[np.ndarray, str]]) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        manifest = {"step": step, "created": time.time(), "leaves": {}}
        shard_idx, shard_bytes, shard_items = 0, 0, {}

        def flush():
            nonlocal shard_idx, shard_bytes, shard_items
            if shard_items:
                np.savez(tmp / f"shard_{shard_idx:04d}.npz", **shard_items)
                shard_idx += 1
                shard_bytes, shard_items = 0, {}

        for name, (arr, dtype) in sorted(host.items()):
            key = name.replace("/", "::")
            if shard_bytes + arr.nbytes > _SHARD_BYTES and shard_items:
                flush()
            shard_items[key] = arr
            shard_bytes += arr.nbytes
            manifest["leaves"][name] = {
                "shard": shard_idx,
                "shape": list(arr.shape),
                "dtype": dtype,
            }
        flush()
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)

        # atomic latest pointer
        ptr_tmp = self.dir / "latest.tmp"
        ptr_tmp.write_text(final.name)
        os.replace(ptr_tmp, self.dir / "latest")
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save failed: {err!r}")

    # -------------------------------------------------------------- restore

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        ptr = self.dir / "latest"
        if ptr.exists():
            name = ptr.read_text().strip()
            if (self.dir / name / "manifest.json").exists():
                return int(name.split("_")[1])
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *,
                device=DEFAULT_DEVICE, shardings: Any = None
                ) -> Tuple[int, Any]:
        """Returns (step, state): the checkpoint at ``step`` (default the
        latest) as a nested dict of tensors on ``device`` (``"cuda"``
        unless the caller asks for ``"cpu"``). With ``shardings`` (a tree
        of shardings matching the saved structure) every leaf is this
        rank's slice on its sharding, on the mesh's device (``device`` for
        a mesh without one): the elastic-restart path."""
        self.wait()
        flat_sh = None
        if shardings is not None:
            flat_sh = flatten_with_names(shardings)
            mesh_device = next(iter(flat_sh.values())).mesh.device
            device = device if mesh_device is None else mesh_device
        device = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())

        shards: Dict[int, Any] = {}

        def shard(i: int):
            if i not in shards:
                shards[i] = np.load(d / f"shard_{i:04d}.npz")
            return shards[i]

        flat = {}
        for name, info in manifest["leaves"].items():
            arr = shard(info["shard"])[name.replace("/", "::")]
            if flat_sh is not None:
                arr = np.array(flat_sh[name].local(arr))
            flat[name] = _tensor(arr, info["dtype"], device)
        return step, _unflatten(flat)
