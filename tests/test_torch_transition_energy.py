"""Port parity for the transition-statistics path (kernel K1 and what it
prices): bit operations, grouping, the MAC energy model, the plain version
of K1 (`repro_torch.kernels.transition_energy.ref`) and `profile_layer`,
each fed the same numpy arrays as its JAX counterpart.

Tolerances and why:
  * bit operations, group ids, histograms and ``count``: exact (integers).
  * ``mac_transition_energy``: rtol 1e-6 — the same float32 formula, whose
    fused or unfused multiply-adds may round differently.
  * ``energy_sum``: rtol 1e-4 — the JAX package sums float32 energies in its
    own order; the port prices integer event sums once in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as jbits
from repro.core import grouping as jgroup
from repro.core.mac_model import DEFAULT_COEFFS as J_COEFFS
from repro.core.mac_model import mac_transition_energy as j_energy
from repro.core.profiler import batched_stats_oracle as j_oracle
from repro.core.profiler import profile_layer as j_profile_layer
from repro.core.stats import pad_to_tiles as j_pad_to_tiles
from repro.core.stats import tile_transition_stats as j_tile_stats
from repro.kernels.transition_energy import ops as j_te_ops
from repro_torch.core import bitops as tbits
from repro_torch.core import grouping as tgroup
from repro_torch.core.mac_model import mac_transition_energy as t_energy
from repro_torch.core.profiler import gather_layer_tiles, profile_layer
from repro_torch.core.stats import pad_to_tiles, tile_psum_trace
from repro_torch.kernels.transition_energy import ops as t_te_ops
from repro_torch.kernels.transition_energy import ref as t_ref
from repro_torch.kernels.transition_energy import transition_energy as tkernel

NAMES = ("energy_sum", "count", "group_hist", "act_hist")
MASK22 = (1 << 22) - 1


def _boundary_values() -> np.ndarray:
    """The pinned values of tests/test_cosim_differential.py (msb22 cases,
    one probe per msb value, one all-ones run per Hamming weight) plus
    their negatives, every single bit, and the int32 extremes."""
    vals = {0, 1, 2, 3, MASK22, 1 << 21, 1 << 22, (1 << 22) | 5, -1,
            (1 << 31) - 1, -(1 << 31), 64 * 127 * 128, -64 * 127 * 128}
    vals |= {1 << b for b in range(31)}
    vals |= {(1 << hw) - 1 for hw in range(31)}
    vals |= {-v for v in list(vals) if -v < (1 << 31)}
    return np.array(sorted(vals), np.int32)


def _values(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "boundary":
        return _boundary_values()
    if kind == "random22":
        return rng.integers(0, 1 << 22, 4096, dtype=np.int64).astype(np.int32)
    return rng.integers(-(1 << 31), 1 << 31, 4096,
                        dtype=np.int64).astype(np.int32)


BIT_FNS = ("popcount", "msb22", "hamming_weight22", "to_bits8", "to_bits16",
           "to_bits22")
GROUP_FNS = ("msb_group", "hd_subgroup", "group_id")


@pytest.mark.parametrize("kind", ["boundary", "random22", "random32"])
@pytest.mark.parametrize("fn", BIT_FNS + GROUP_FNS)
def test_unary_bit_and_group_functions_match_jax(fn, kind):
    x = _values(kind)
    jmod, tmod = (jbits, tbits) if fn in BIT_FNS else (jgroup, tgroup)
    want = np.asarray(getattr(jmod, fn)(jnp.asarray(x)))
    got = getattr(tmod, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["boundary", "random22", "random32"])
@pytest.mark.parametrize("fn", ["hamming_distance", "carry_chain_length",
                                "group_transition_id"])
def test_binary_bit_and_group_functions_match_jax(fn, kind):
    x = _values(kind)
    y = np.roll(x, 1)
    jmod = jgroup if fn == "group_transition_id" else jbits
    tmod = tgroup if fn == "group_transition_id" else tbits
    want = np.asarray(getattr(jmod, fn)(jnp.asarray(x), jnp.asarray(y)))
    got = getattr(tmod, fn)(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, want)


def test_msb22_mask_applies_before_the_zero_test():
    cases = {0: -1, 1: 0, 2: 1, 3: 1, MASK22: 21, 1 << 21: 21,
             1 << 22: -1, (1 << 22) | 5: 2, -1: 21}
    x = torch.tensor(list(cases), dtype=torch.int32)
    assert tbits.msb22(x).tolist() == list(cases.values())


def test_group_representatives_fall_in_their_msb_group():
    gen = torch.Generator().manual_seed(17)
    reps = tgroup.group_representatives(gen, 8)
    again = tgroup.group_representatives(torch.Generator().manual_seed(17), 8)
    assert reps.shape == (50, 8) and reps.dtype == torch.int32
    assert torch.equal(reps, again)
    assert int(reps.min()) >= 0 and int(reps.max()) <= MASK22
    mg = tgroup.msb_group(reps)
    assert torch.equal(mg, (torch.arange(50) // 5)[:, None].expand(50, 8)
                       .to(torch.int32))


def test_mac_transition_energy_matches_jax():
    rng = np.random.default_rng(3)
    n = 20000
    w = rng.integers(-128, 128, n).astype(np.int32)
    w[:512] = 0                                     # the zero-gated branch
    a_prev, a_cur = (rng.integers(-128, 128, n).astype(np.int32)
                     for _ in range(2))
    p_prev, p_cur = (rng.integers(-(1 << 21), 1 << 21, n).astype(np.int32)
                     for _ in range(2))
    args = (w, a_prev, a_cur, p_prev, p_cur)
    want = np.asarray(j_energy(*map(jnp.asarray, args)))
    got = t_energy(*map(torch.from_numpy, args)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------- K1 itself


def _tiles(seed, n, t_len, boundary_tile=True):
    """n random int8 tiles; the first one at the extremes (weights +-127,
    activations alternating +-127 / -128 / 0) so psums reach their largest
    magnitude of both signs and change sign from t to t + 1."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-128, 128, (n, 64, 64)).astype(np.int32)
    a = rng.integers(-128, 128, (n, 64, t_len)).astype(np.int32)
    w[:, :, :3] = 0                                 # zero-gated MACs
    if boundary_tile:
        w[0] = np.where(rng.random((64, 64)) < 0.5, 127, -127)
        w[0, :, 0] = 127
        col = np.array([127, -128, 0, -127] * t_len)[:t_len]
        a[0] = col[None, :]
    return w, a


def _assert_stats(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        if name == "energy_sum":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3,
                                       err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


def test_plain_k1_matches_jax_oracle_and_kernel_interpret():
    """ref.py vs the JAX oracle and vs the JAX Pallas kernel in interpret
    mode, 3 tiles at T = 12 (interpret mode is slow)."""
    w, a = _tiles(0, 3, 12)
    got = t_ref.transition_stats_ref(torch.from_numpy(w), torch.from_numpy(a))
    mask = jnp.ones((3,), jnp.float32)
    _assert_stats(got, j_oracle(jnp.asarray(w), jnp.asarray(a), mask,
                                J_COEFFS), "oracle")
    _assert_stats(got, j_te_ops.batched_transition_stats(
        jnp.asarray(w), jnp.asarray(a), J_COEFFS, mask=mask, interpret=True),
        "kernel interpret")


def test_plain_k1_matches_jax_oracle_at_profile_width(monkeypatch):
    """T = 64 (the profile path's streaming width), 8 tiles, chunked: the
    chunk size is forced to 3 tiles, below the batch."""
    w, a = _tiles(1, 8, 64)
    monkeypatch.setattr(t_ref, "_CHUNK_ELEMS", 3 * 64 * 64 * 64)
    assert t_ref.chunk_tiles(64) == 3
    got = t_ref.transition_stats_ref(torch.from_numpy(w), torch.from_numpy(a))
    _assert_stats(got, j_oracle(jnp.asarray(w), jnp.asarray(a),
                                jnp.ones((8,), jnp.float32), J_COEFFS),
                  "oracle T=64")


def test_integer_counts_price_to_the_plain_stats():
    w, a = _tiles(2, 2, 9)
    events, gh, ah = t_ref.transition_counts(torch.from_numpy(w),
                                             torch.from_numpy(a))
    assert events.dtype == gh.dtype == ah.dtype == torch.int64
    assert int(events[:, 0].sum()) == 2 * 64 * 64 * 8
    assert int(gh.sum()) == 2 * 64 * 64 * 8 and int(ah.sum()) == 2 * 64 * 8
    # energy_sum from the float64 pricing == per-MAC float64 energies summed
    psum = tile_psum_trace(torch.from_numpy(w[0]), torch.from_numpy(a[0]))
    wt = torch.from_numpy(w[0])[:, :, None]
    at = torch.from_numpy(a[0])[:, None, :]
    e = t_energy(wt, at[..., :-1], at[..., 1:], psum[..., :-1],
                 psum[..., 1:]).double()
    want = torch.zeros(256, dtype=torch.float64).index_add_(
        0, (wt[..., 0] + 128).reshape(-1).long(), e.sum(-1).reshape(-1))
    one, _, _ = t_ref.transition_counts(torch.from_numpy(w[:1]),
                                        torch.from_numpy(a[:1]))
    np.testing.assert_allclose(t_ref.finish_stats(one, gh, ah)[0].numpy(),
                               want.numpy(), rtol=1e-6)


def test_mask_zero_padding_tiles_contribute_nothing():
    w, a = _tiles(3, 3, 10)
    pad_w = np.full((2, 64, 64), 55, np.int32)     # nonzero garbage
    pad_a = np.full((2, 64, 10), -7, np.int32)
    ww = torch.from_numpy(np.concatenate([w, pad_w]))
    aa = torch.from_numpy(np.concatenate([a, pad_a]))
    mask = torch.tensor([1, 1, 1, 0, 0], dtype=torch.float32)
    got = t_te_ops.batched_transition_stats(ww, aa, mask=mask)
    want = t_te_ops.batched_transition_stats(torch.from_numpy(w),
                                             torch.from_numpy(a))
    for g, h in zip(got, want):
        assert torch.equal(g, h)


def test_tile_stats_k1b_is_a_batch_of_one():
    w, a = _tiles(4, 1, 12)
    got = t_te_ops.tile_transition_stats(torch.from_numpy(w[0]),
                                         torch.from_numpy(a[0]))
    _assert_stats(got, j_tile_stats(jnp.asarray(w[0]), jnp.asarray(a[0]),
                                    J_COEFFS), "tile oracle")
    _assert_stats(got, j_te_ops.tile_transition_stats(
        jnp.asarray(w[0]), jnp.asarray(a[0]), J_COEFFS, interpret=True),
        "tile kernel interpret")


def _good_inputs():
    w, a = _tiles(5, 2, 4, boundary_tile=False)
    return torch.from_numpy(w), torch.from_numpy(a), torch.ones(2)


BAD_INPUTS = {
    "w_shape": lambda w, a, m: (w[:, :32], a, m),
    "a_rows": lambda w, a, m: (w, a[:, :32], m),
    "a_batch": lambda w, a, m: (w, a[:1], m),
    "t_one": lambda w, a, m: (w, a[:, :, :1].contiguous(), m),
    "t_too_long": lambda w, a, m: (w, a.repeat(1, 1, 129), m),
    "mask_shape": lambda w, a, m: (w, a, m[:1]),
    "w_dtype": lambda w, a, m: (w.long(), a, m),
    "a_dtype": lambda w, a, m: (w, a.to(torch.int16), m),
    "mask_dtype": lambda w, a, m: (w, a, m.double()),
    "w_strided": lambda w, a, m: (w.transpose(1, 2), a, m),
    "a_strided": lambda w, a, m: (w, a[:, :, ::2], m),
    "w_range": lambda w, a, m: (w + 200, a, m),
    "a_range": lambda w, a, m: (w, a - 300, m),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_bad_inputs_raise_before_dispatch(case):
    w, a, m = BAD_INPUTS[case](*_good_inputs())
    with pytest.raises(ValueError):
        t_te_ops.batched_transition_stats(w, a, mask=m)


def test_kernel_wrapper_refuses_cpu_tensors():
    w, a, m = _good_inputs()
    before = tkernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.launch(w, a, m)
    assert tkernel.launches == before



@pytest.mark.parametrize("slabs,slab_len", [(1, 22), (2, 11), (5, 5),
                                            (8, 3), (22, 1)])
def test_transition_slabs_sum_to_the_whole_tile(slabs, slab_len):
    """K1's split of a tile over blocks: the plain counts of T-slabs of the
    same tiles (columns t0..t1 inclusive, neighbours sharing one column, so
    the slabs partition the transitions) sum to the whole tiles' integer
    counts; events and group histogram, and the activation-pair histogram
    too, since each slab counts only its own pairs."""
    w, a = _tiles(6, 2, 23)
    wt, at = torch.from_numpy(w), torch.from_numpy(a)
    whole = t_ref.transition_counts(wt, at)
    parts = [torch.zeros_like(x) for x in whole]
    for s in range(slabs):
        t0 = s * slab_len
        t1 = min(t0 + slab_len, 22)          # 23 columns, 22 transitions
        for acc, x in zip(parts, t_ref.transition_counts(
                wt, at[:, :, t0:t1 + 1].contiguous())):
            acc += x
    for name, got, want in zip(("events", "group_hist", "act_hist"), parts,
                               whole):
        assert torch.equal(got, want), name


@pytest.mark.parametrize("n_tiles,t_len", [
    (16, 64), (4, 64), (1, 64), (64, 64), (12288, 64), (16, 2), (3, 512),
    (7, 9)])
def test_launch_plan_partitions_the_transitions(n_tiles, t_len):
    """`launch_plan` (slabs, slab_len): the slabs cover every transition and
    none is empty; the profile path's 16-tile launch at T = 64 puts at
    least 128 blocks on the 132 SMs of an H100; thousands of tiles keep one
    slab a tile."""
    slabs, slab_len = tkernel.launch_plan(n_tiles, t_len, 132)
    n_trans = t_len - 1
    assert slabs * slab_len >= n_trans > (slabs - 1) * slab_len
    assert slab_len >= min(tkernel.MIN_SLAB, n_trans)
    if (n_tiles, t_len) == (16, 64):
        assert n_tiles * slabs >= 128
    if n_tiles == 12288:
        assert slabs == 1

# ------------------------------------------------------------ profile_layer


def test_gather_layer_tiles_matches_jax():
    from repro.core.profiler import gather_layer_tiles as j_gather

    rng = np.random.default_rng(6)
    w = rng.integers(-100, 100, (96, 70)).astype(np.int32)
    x = rng.integers(-100, 100, (70, 150)).astype(np.int32)
    idx = np.array([0, 5, 11, 3, 7], np.int32)       # of 2*2*3 tiles
    jw, jx = j_pad_to_tiles(jnp.asarray(w), jnp.asarray(x))
    tw, tx = pad_to_tiles(torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    for got, want in zip(gather_layer_tiles(tw, tx, torch.from_numpy(idx)),
                         j_gather(jw, jx, jnp.asarray(idx))):
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_profile_layer_with_the_jax_tile_indices():
    rng = np.random.default_rng(7)
    w = rng.integers(-127, 128, (96, 70)).astype(np.int32)
    x = rng.integers(-127, 128, (70, 150)).astype(np.int32)
    key = jax.random.PRNGKey(123)
    want = j_profile_layer(jnp.asarray(w), jnp.asarray(x), max_tiles=5,
                           key=key)
    idx = np.asarray(jax.random.choice(key, 12, (5,), replace=False))
    got = profile_layer(torch.from_numpy(w), torch.from_numpy(x),
                        max_tiles=5, tile_idx=torch.from_numpy(idx))
    assert got.n_transitions == want.n_transitions
    _assert_stats([getattr(got, n) for n in NAMES],
                  [getattr(want, n) for n in NAMES], "profile_layer")


def test_profile_layer_sampling_is_seeded():
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.integers(-127, 128, (70, 64)).astype(np.int32))
    x = torch.from_numpy(rng.integers(-127, 128, (64, 300)).astype(np.int32))
    a = profile_layer(w, x, max_tiles=3, seed=5)
    b = profile_layer(w, x, max_tiles=3, seed=5)
    assert a.n_transitions == 3 * 64 * 64 * 63
    for n in NAMES:
        assert torch.equal(getattr(a, n), getattr(b, n))
