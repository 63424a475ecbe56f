"""Batched whole-layer systolic profiling (port of `repro.core.profiler`,
paper 3.1.2).

  1. ``gather_layer_tiles`` — the sampled (mi, ki, ni) tiles of a layer are
     gathered into stacked (n_tiles, 64, 64) weight / (n_tiles, 64, T)
     activation batches with one indexing op per operand.
  2. ``batched_layer_stats`` — the whole batch runs as one transition-
     statistics launch (`repro_torch.kernels.transition_energy.ops`): the
     CUDA kernel for CUDA tensors, the plain version for CPU tensors;
     ``batched_layer_counts`` returns that launch's integer statistics.
  3. ``profile_layer`` — sampling + gather + trace + `LayerStats` assembly.

Padding semantics are the JAX package's: partial tiles are zero-padded by
`pad_to_tiles` and the padded MACs do count (w = 0 still clocks, matching
`weight_value_counts`); tiles whose mask is 0 contribute nothing.

``sharded_layer_stats`` splits the tile batch over a 1-D ("tiles",) mesh
(`repro_torch.distributed.sharding.tile_mesh`): the batch is zero-padded
with masked tiles to a multiple of the mesh size, each shard's slice runs
as one launch on its device, and the shards' int64 statistics are summed on
the mesh's first device and priced once there. The JAX package psums the
four priced float32 outputs instead; summing the integers first makes the
sharded statistics equal the unsharded ones bit for bit, floats included.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.mac_model import DEFAULT_COEFFS, MacEnergyCoeffs
from repro_torch.core.stats import TILE, LayerStats, StatsTuple, pad_to_tiles
from repro_torch.distributed.sharding import (
    TILE_AXIS,
    LocalMesh,
    check_mesh,
    device_scope,
    sum_on,
    tile_mesh,
)
from repro_torch.kernels.transition_energy import ops as te_ops
from repro_torch.kernels.transition_energy.ref import (
    CountsTuple,
    finish_stats,
    transition_stats_ref,
)


def gather_layer_tiles(w_pad: torch.Tensor, x_pad: torch.Tensor,
                       tile_idx: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack sampled tiles: (n, 64, 64) stationary (K x M) + (n, 64, T)
    blocks, both contiguous.

    ``tile_idx`` holds flat (mi, ki, ni) indices in mi-major order,
    ``idx = (mi * kt + ki) * nt + ni`` — the JAX package's enumeration."""
    mp, kp = w_pad.shape
    kp2, np_ = x_pad.shape
    if kp != kp2:
        raise ValueError(f"contraction mismatch: {kp} vs {kp2}")
    kt, nt = kp // TILE, np_ // TILE
    idx = tile_idx.to(device=w_pad.device, dtype=torch.int64)
    mi = idx // (kt * nt)
    rest = idx % (kt * nt)
    ki = rest // nt
    ni = rest % nt
    # advanced indices split by a slice put the tile axis first:
    # w_pad[mi*T:(mi+1)T, ki*T:(ki+1)T] -> (n, M_t, K_t), transposed to K x M
    w_tiles = w_pad.reshape(mp // TILE, TILE, kt, TILE)[mi, :, ki, :]
    a_blocks = x_pad.reshape(kt, TILE, nt, TILE)[ki, :, ni, :]
    return (w_tiles.transpose(1, 2).contiguous(), a_blocks.contiguous())


def batched_stats_oracle(w_tiles: torch.Tensor, a_blocks: torch.Tensor,
                         mask: torch.Tensor,
                         coeffs: MacEnergyCoeffs = DEFAULT_COEFFS
                         ) -> StatsTuple:
    """Plain trace of the whole tile batch, reduced to layer sums, on any
    device (the port's counterpart of the JAX oracle of the same name)."""
    return transition_stats_ref(w_tiles, a_blocks, coeffs, mask=mask)


def batched_layer_stats(w_tiles: torch.Tensor, a_blocks: torch.Tensor,
                        coeffs: MacEnergyCoeffs = DEFAULT_COEFFS, *,
                        mask: Optional[torch.Tensor] = None) -> StatsTuple:
    """One batched trace launch: the kernel on CUDA, the plain version on
    the CPU."""
    return te_ops.batched_transition_stats(w_tiles, a_blocks, coeffs,
                                           mask=mask)


def batched_layer_counts(w_tiles: torch.Tensor, a_blocks: torch.Tensor, *,
                         mask: Optional[torch.Tensor] = None
                         ) -> CountsTuple:
    """The same launch as `batched_layer_stats`, its int64 statistics
    returned before pricing and the float32 conversion: exact at any tile
    count. The cosim gate compares these, and reaches K1 only through this
    function (`repro_torch.cosim` imports nothing of the kernels)."""
    return te_ops.batched_transition_counts(w_tiles, a_blocks, mask=mask)


def sharded_layer_counts(w_tiles: torch.Tensor, a_blocks: torch.Tensor, *,
                         mask: Optional[torch.Tensor] = None,
                         mesh: Optional[LocalMesh] = None) -> CountsTuple:
    """`batched_layer_counts` with the tile batch split over a 1-D
    ("tiles",) mesh (every visible card when None): the batch zero-padded
    up to a multiple of the mesh size with tiles whose mask is 0, one
    launch a shard on the shard's device, the int64 statistics summed on
    the mesh's first device in shard order."""
    mesh = check_mesh(tile_mesh() if mesh is None else mesh, TILE_AXIS)
    n_dev = mesh.size
    n = w_tiles.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.float32, device=w_tiles.device)
    pad = (-n) % n_dev
    if pad:
        w_tiles = torch.cat([w_tiles, w_tiles.new_zeros(
            (pad,) + tuple(w_tiles.shape[1:]))])
        a_blocks = torch.cat([a_blocks, a_blocks.new_zeros(
            (pad,) + tuple(a_blocks.shape[1:]))])
        mask = torch.cat([mask, mask.new_zeros((pad,))])
    step = (n + pad) // n_dev
    outs = []
    for i, dev in enumerate(mesh.devices):
        rows = slice(i * step, (i + 1) * step)
        with device_scope(dev):
            outs.append(batched_layer_counts(
                w_tiles[rows].to(dev), a_blocks[rows].to(dev),
                mask=mask[rows].to(dev)))
    return tuple(sum_on(parts, mesh.first) for parts in zip(*outs))


def sharded_layer_stats(w_tiles: torch.Tensor, a_blocks: torch.Tensor,
                        coeffs: MacEnergyCoeffs = DEFAULT_COEFFS, *,
                        mask: Optional[torch.Tensor] = None,
                        mesh: Optional[LocalMesh] = None) -> StatsTuple:
    """The tile batch's four statistics through `sharded_layer_counts`,
    priced once on the mesh's first device: equal, bin for bin, to
    `batched_layer_stats` on the whole batch."""
    return finish_stats(*sharded_layer_counts(w_tiles, a_blocks, mask=mask,
                                              mesh=mesh), coeffs)


def sample_tiles(total_tiles: int, max_tiles: int, seed: int) -> torch.Tensor:
    """``min(max_tiles, total_tiles)`` distinct flat tile indices, drawn on
    the CPU from a generator seeded with ``seed`` (the same tiles on every
    device; not the tiles `jax.random.choice` picks)."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randperm(total_tiles, generator=gen)[:max_tiles]


def profile_layer(w_mat: torch.Tensor, x_cols: torch.Tensor, *,
                  max_tiles: int = 48, seed: int = 0,
                  tile_idx: Optional[torch.Tensor] = None,
                  coeffs: MacEnergyCoeffs = DEFAULT_COEFFS,
                  mesh: Optional[LocalMesh] = None) -> LayerStats:
    """Trace a layer's matmul on the 64x64 array: one kernel launch, or
    one a shard of ``mesh``.

    w_mat (M, K) and x_cols (K, N) int8-valued, on one device. Samples
    ``max_tiles`` tiles with `sample_tiles` unless ``tile_idx`` names them
    (the flat indices of `gather_layer_tiles`, e.g. the ones the JAX
    package drew). ``mesh``, or CUDA inputs with more than one card
    visible (the JAX package's ``jax.device_count() > 1``), routes the
    batch through `sharded_layer_stats`."""
    w_pad, x_pad = pad_to_tiles(w_mat.to(torch.int32), x_cols.to(torch.int32))
    total_tiles = ((w_pad.shape[0] // TILE) * (w_pad.shape[1] // TILE)
                   * (x_pad.shape[1] // TILE))
    if tile_idx is None:
        tile_idx = sample_tiles(total_tiles, max_tiles, seed)
    w_tiles, a_blocks = gather_layer_tiles(w_pad, x_pad, tile_idx)
    if mesh is not None or (w_tiles.device.type == "cuda"
                            and torch.cuda.device_count() > 1):
        es, cnt, gh, ah = sharded_layer_stats(w_tiles, a_blocks, coeffs,
                                              mesh=mesh)
    else:
        es, cnt, gh, ah = batched_layer_stats(w_tiles, a_blocks, coeffs)
    n = w_tiles.shape[0]
    return LayerStats(act_hist=ah, group_hist=gh, energy_sum=es, count=cnt,
                      n_transitions=n * TILE * TILE * (a_blocks.shape[2] - 1))
