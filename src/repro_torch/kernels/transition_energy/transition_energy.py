"""Build, load and launch the CUDA transition-statistics kernel (K1,
``csrc/transition_energy.cu``).

The kernel replaces the TPU kernel
``repro.kernels.transition_energy.transition_energy
.transition_stats_batched_pallas``; the source's header says what bounds it
on an H100 and how its design responds. It returns integer statistics, which
`repro_torch.kernels.transition_energy.ref.finish_stats` turns into the four
float32 outputs, exactly as for the plain version.

The source compiles at first use with ``nvcc`` for ``sm_90a`` into
``build/transition_energy/`` at the repository root and is loaded with
`ctypes` (`repro_torch.kernels._build`). Nothing here runs at import.

`launch_plan` shapes each launch's grid (tiles x slabs of transitions) and
its slabs from the tile count, T and the card's SMs.

``launches`` counts kernel launches (one per `launch` call that reached the
device), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.core.grouping import N_GROUPS
from repro_torch.core.mac_model import N_EVENTS
from repro_torch.core.stats import N_WVALS, TILE
from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "transition_energy.cu"
LIBRARY = KernelLibrary(
    "transition_energy", SOURCE,
    {"transition_counts_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5,
     "transition_counts_config": [ctypes.c_int] * 2 + [ctypes.c_void_p]})
MAX_T = 512        # the activation block lives in shared memory
BLOCKS_PER_SM = 2  # blocks a launch aims at for every SM, before slabs stop
MIN_SLAB = 4       # transitions a slab holds at least (when T - 1 allows)
CONFIG_FIELDS = ("registers", "spill_bytes", "blocks_per_sm", "smem_bytes")
N_BINS = N_WVALS * N_EVENTS + N_GROUPS * N_GROUPS + N_WVALS * N_WVALS

launches = 0       # kernel launches in this process


def launch_plan(n_tiles: int, t_len: int, sms: int) -> Tuple[int, int]:
    """(slabs, slab_len) of a launch over ``n_tiles`` tiles of T =
    ``t_len`` columns on a card of ``sms`` SMs: each tile's T - 1
    transitions cut into ``slabs`` slabs of ``slab_len`` (the last may be
    shorter, none is empty) so that the launch has about `BLOCKS_PER_SM`
    blocks for every SM, no slab shorter than `MIN_SLAB` transitions."""
    n_trans = t_len - 1
    want = -(-BLOCKS_PER_SM * sms // max(n_tiles, 1))    # slabs a tile
    slab_len = max(min(MIN_SLAB, n_trans), -(-n_trans // want))
    return -(-n_trans // slab_len), slab_len


def config(slab_len: int, device: int = 0) -> dict:
    """The kernel's resources at a slab length on a card: `CONFIG_FIELDS`
    (registers and spill bytes a thread, resident blocks per SM, dynamic
    shared memory a block)."""
    info = (ctypes.c_int * len(CONFIG_FIELDS))()
    err = LIBRARY.load().transition_counts_config(slab_len, device,
                                                  ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"transition_counts_config failed: CUDA error "
                           f"{err}")
    return dict(zip(CONFIG_FIELDS, info))


@functools.cache
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index`` (cached)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(w_tiles: torch.Tensor, a_blocks: torch.Tensor,
           mask: torch.Tensor):
    """Launch the kernel on CUDA tensors already validated by
    `repro_torch.kernels.transition_energy.ops.check_inputs` (w_tiles
    (n, 64, 64) int32, a_blocks (n, 64, T) int32, mask (n,) float32, all
    contiguous), with the grid of `launch_plan`. Returns the int64
    ``(events (256, 5), group_hist (2500,), act_hist (65536,))`` of
    `ref.transition_counts`; raises `RuntimeError` if the launch failed."""
    global launches
    if w_tiles.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel needs CUDA tensors, got {w_tiles.device}")
    dev = w_tiles.device
    n, t_len = w_tiles.shape[0], a_blocks.shape[2]
    if n == 0:
        return _bins(torch.zeros((N_BINS,), dtype=torch.int64, device=dev))
    # one allocation, zeroed by the entry point on the stream, so a launch
    # costs the host one tensor and one call
    bins = torch.empty((N_BINS,), dtype=torch.int64, device=dev)
    slabs, slab_len = launch_plan(n, t_len, sm_count(dev.index))
    # the raw cudaStream_t of PyTorch's current stream, as K2's wrapper
    # takes it (no Stream object a launch)
    err = LIBRARY.load().transition_counts_launch(
        w_tiles.data_ptr(), a_blocks.data_ptr(), mask.data_ptr(),
        bins.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index),
        dev.index, n, t_len, slabs, slab_len)
    if err != 0:
        raise RuntimeError(
            f"transition_energy kernel launch failed: CUDA error {err} at "
            f"n_tiles={n} T={t_len} (tile {TILE}x{TILE}), {slabs} slabs of "
            f"{slab_len}")
    launches += 1
    return _bins(bins)


def _bins(bins: torch.Tensor):
    """(events (256, 5), group_hist (2500,), act_hist (65536,)) views of
    the kernel's one int64 output buffer, in that order."""
    n_ev = N_WVALS * N_EVENTS
    return (bins[:n_ev].view(N_WVALS, N_EVENTS),
            bins[n_ev:n_ev + N_GROUPS * N_GROUPS],
            bins[n_ev + N_GROUPS * N_GROUPS:])
