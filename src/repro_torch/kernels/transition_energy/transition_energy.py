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

``launches`` counts kernel launches (one per `launch` call that reached the
device), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.grouping import N_GROUPS
from repro_torch.core.mac_model import N_EVENTS
from repro_torch.core.stats import N_WVALS, TILE
from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "transition_energy.cu"
LIBRARY = KernelLibrary(
    "transition_energy", SOURCE,
    {"transition_counts_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3})
MAX_T = 512        # the activation block lives in shared memory

launches = 0       # kernel launches in this process


def launch(w_tiles: torch.Tensor, a_blocks: torch.Tensor,
           mask: torch.Tensor):
    """Launch the kernel on CUDA tensors already validated by
    `repro_torch.kernels.transition_energy.ops.check_inputs` (w_tiles
    (n, 64, 64) int32, a_blocks (n, 64, T) int32, mask (n,) float32, all
    contiguous). Returns the int64 ``(events (256, 5), group_hist (2500,),
    act_hist (65536,))`` of `ref.transition_counts`; raises `RuntimeError`
    if the launch failed."""
    global launches
    if w_tiles.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel needs CUDA tensors, got {w_tiles.device}")
    dev = w_tiles.device
    events = torch.zeros((N_WVALS, N_EVENTS), dtype=torch.int64, device=dev)
    group_hist = torch.zeros((N_GROUPS * N_GROUPS,), dtype=torch.int64,
                             device=dev)
    act_hist = torch.zeros((N_WVALS * N_WVALS,), dtype=torch.int64,
                           device=dev)
    n, t_len = w_tiles.shape[0], a_blocks.shape[2]
    if n == 0:
        return events, group_hist, act_hist
    lib = LIBRARY.load()
    err = lib.transition_counts_launch(
        w_tiles.data_ptr(), a_blocks.data_ptr(), mask.data_ptr(),
        events.data_ptr(), group_hist.data_ptr(), act_hist.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index or 0, n, t_len)
    if err != 0:
        raise RuntimeError(
            f"transition_energy kernel launch failed: CUDA error {err} at "
            f"n_tiles={n} T={t_len} (tile {TILE}x{TILE})")
    launches += 1
    return events, group_hist, act_hist
