"""Port parity: `repro_torch.core.{qat,stats}` and `repro_torch.nn.layers`
against the JAX package on the same numpy inputs.

Integer quantizers must be bit-exact (they decide which int8 value sits in a
MAC register); float layers agree to rtol/atol 1e-5, the float32 round-off of
a different summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import qat as jqat
from repro.core import stats as jstats
from repro.nn import layers as jL
from repro_torch.core import qat as tqat
from repro_torch.core import stats as tstats
from repro_torch.nn import layers as tL
from repro_torch.nn.spec import params_from_numpy

CPU = "cpu"


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def j2t(tree):
    return params_from_numpy(jax.device_get(tree), CPU)


def assert_same(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


CODEBOOKS = [
    [-96, -32, 0, 64],
    [-10, 10],                          # 0 is a tie: goes to -10
    [-40, -40, 0, 10, 10, 10],          # duplicates
    [-120, -80, -45, -20, -5],          # all negative
    [-127, -3, 0, 1, 2, 126],
    list(range(-120, 121, 16)),         # 16 values
]


# ----------------------------------------------------------------- codebooks


@pytest.mark.parametrize("values", CODEBOOKS + [[]])
def test_make_codebook_matches(values):
    jcb, jk = jqat.make_codebook(values)
    tcb, tk = tqat.make_codebook(values, device=CPU)
    assert_same(tcb, jcb)
    assert int(tk) == int(jk) and tk.dtype == torch.int32


@pytest.mark.parametrize("values", CODEBOOKS)
@pytest.mark.parametrize("k_override", [None, 0, 1])
def test_project_to_codebook_exhaustive(values, k_override):
    """Every int8 value, ties toward the smaller value, k=0 identity, and a
    k smaller than the padded codebook."""
    jcb, jk = jqat.make_codebook(values)
    k = jk if k_override is None else jnp.asarray(k_override, jnp.int32)
    q = np.arange(-128, 128, dtype=np.int32).reshape(16, 16)
    want = jqat.project_to_codebook(jnp.asarray(q), jcb, k)
    got = tqat.project_to_codebook(t(q), t(jcb), t(k))
    assert_same(got, want)
    if values == [-10, 10] and k_override is None:
        assert int(got.reshape(-1)[128]) == -10      # q = 0 ties low


@pytest.mark.parametrize("bits", list(range(9)))
def test_msr_truncate_int_all_int8(bits):
    q = np.arange(-128, 128, dtype=np.int32)
    assert_same(tqat.msr_truncate_int(t(q), bits),
                jqat.msr_truncate_int(jnp.asarray(q), bits))


def test_round_half_to_even():
    """One column with amax 127 has scale exactly 1: w/scale hits .5 ties,
    which both frameworks round to even."""
    col = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 127.0, -126.5],
                   np.float32)
    w = np.stack([col, col * 0.25], axis=1)
    want = jqat.quantize_weight_int(jnp.asarray(w))
    got = tqat.quantize_weight_int(t(w))
    assert_same(got, want)
    assert got[:6, 0].tolist() == [0, 2, 2, 0, -2, 4]


def _jax_comp(w, values, *, prune=0.0, msr=0):
    c = jqat.identity_comp(w.shape)
    c["codebook"], c["codebook_k"] = jqat.make_codebook(values)
    c["msr_bits"] = jnp.asarray(msr, jnp.int32)
    if prune:
        c["mask"] = jqat.magnitude_prune_mask(jnp.asarray(w), prune)
    return c


@pytest.mark.parametrize("values", [CODEBOOKS[0], CODEBOOKS[3], CODEBOOKS[5],
                                    []])
@pytest.mark.parametrize("prune,msr", [(0.0, 0), (0.5, 0), (0.3, 3)])
def test_weight_quantizers_bit_exact(values, prune, msr):
    rng = np.random.default_rng(len(values) * 10 + msr)
    w = (rng.normal(size=(3, 3, 5, 12)) * 0.1).astype(np.float32)
    jc = _jax_comp(w, values, prune=prune, msr=msr)
    tc = j2t(jc)
    assert_same(tqat.weight_scale(t(w)), jqat.weight_scale(jnp.asarray(w)))
    assert_same(tqat.quantize_weight_int(t(w), tc),
                jqat.quantize_weight_int(jnp.asarray(w), jc))
    assert_same(tqat.fake_quant_weight(t(w), tc),
                jqat.fake_quant_weight(jnp.asarray(w), jc))
    assert_same(tqat.fake_quant_weight(t(w)),
                jqat.fake_quant_weight(jnp.asarray(w)))


def test_fake_quant_weight_ste_gradient_is_mask():
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(16, 8)) * 0.1).astype(np.float32)
    g = rng.normal(size=w.shape).astype(np.float32)
    jc = _jax_comp(w, CODEBOOKS[0], prune=0.5)
    want = jax.grad(lambda v: jnp.sum(jqat.fake_quant_weight(v, jc) * g))(
        jnp.asarray(w))
    wt = t(w).requires_grad_(True)
    (tqat.fake_quant_weight(wt, j2t(jc)) * t(g)).sum().backward()
    assert_same(wt.grad, want)
    assert_same(wt.grad, g * np.asarray(jc["mask"]))


@pytest.mark.parametrize("shape,scale", [((2, 7, 7, 3), 1.0),
                                         ((5, 33), 40.0)])
def test_activation_quantizers_bit_exact(shape, scale):
    a = (np.random.default_rng(1).normal(size=shape) * scale).astype(np.float32)
    assert_same(tqat.fake_quant_act(t(a)), jqat.fake_quant_act(jnp.asarray(a)))
    assert_same(tqat.quantize_act_int(t(a)),
                jqat.quantize_act_int(jnp.asarray(a)))


@settings(max_examples=25, deadline=None)
@given(st.lists(st.floats(-4.0, 4.0, width=32), min_size=24, max_size=24),
       st.sets(st.integers(-127, 127), min_size=1, max_size=16))
def test_quantize_weight_int_property(vals, values):
    """Any float weights, any codebook: identical integer weights."""
    w = np.asarray(vals, np.float32).reshape(6, 4)
    jc = _jax_comp(w, sorted(values))
    assert_same(tqat.quantize_weight_int(t(w), j2t(jc)),
                jqat.quantize_weight_int(jnp.asarray(w), jc))


@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.5, 0.9])
def test_magnitude_prune_mask_matches(ratio):
    w = (np.random.default_rng(4).normal(size=(3, 3, 4, 8))).astype(np.float32)
    assert_same(tqat.magnitude_prune_mask(t(w), ratio),
                jqat.magnitude_prune_mask(jnp.asarray(w), ratio))


def test_identity_comp_matches():
    jc = jqat.identity_comp((3, 3, 2, 4))
    tc = tqat.identity_comp((3, 3, 2, 4), device=CPU)
    assert set(jc) == set(tc)
    for k in jc:
        assert_same(tc[k], jc[k])


# -------------------------------------------------------------------- im2col


@pytest.mark.parametrize("hw", [7, 8])
@pytest.mark.parametrize("kernel", [1, 3, 5])
@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID"), (2, "VALID")])
def test_im2col_exact(hw, kernel, stride, padding):
    x = np.random.default_rng(hw + kernel).normal(
        size=(2, hw, hw, 3)).astype(np.float32)
    want = jstats.im2col(jnp.asarray(x), (kernel, kernel), stride, padding)
    got = tstats.im2col(t(x), (kernel, kernel), stride, padding)
    assert_same(got, want)
    rows = tstats.im2col_rows(t(x), (kernel, kernel), stride, padding,
                              k_pad=got.shape[0] + 5)
    assert rows.is_contiguous()
    assert_same(rows[:, :got.shape[0]], want.T)
    assert not rows[:, got.shape[0]:].any()


def test_conv_weight_matrix_exact():
    w = np.random.default_rng(0).normal(size=(3, 3, 4, 6)).astype(np.float32)
    assert_same(tstats.conv_weight_matrix(t(w)),
                jstats.conv_weight_matrix(jnp.asarray(w)))


# -------------------------------------------------------------------- layers

TOL = dict(rtol=1e-5, atol=1e-5)   # float32, summation order only


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("hw", [8, 9])
@pytest.mark.parametrize("kernel,stride,padding",
                         [(3, 1, "SAME"), (3, 2, "SAME"), (1, 2, "SAME"),
                          (5, 1, "VALID"), (3, 2, "VALID")])
@pytest.mark.parametrize("activation", ["none", "relu", "gelu"])
def test_apply_conv_matches(hw, kernel, stride, padding, activation):
    rng = np.random.default_rng(hw * 7 + kernel + stride)
    x = rng.normal(size=(2, hw, hw, 4)).astype(np.float32)
    p = {"w": (rng.normal(size=(kernel, kernel, 4, 6)) * 0.3).astype(np.float32),
         "b": rng.normal(size=(6,)).astype(np.float32)}
    res_shape = np.asarray(jL.apply_conv(p, jnp.asarray(x), stride=stride,
                                         padding=padding)).shape
    res = rng.normal(size=res_shape).astype(np.float32)
    kw = dict(stride=stride, padding=padding, activation=activation)
    want = jL.apply_conv(p, jnp.asarray(x), residual=jnp.asarray(res), **kw)
    got = tL.apply_conv(j2t(p), t(x), residual=t(res), **kw)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("activation", sorted(tL.ACTIVATIONS))
@pytest.mark.parametrize("quant", ["off", "on"])
def test_apply_dense_matches(activation, quant):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(5, 3, 24)).astype(np.float32)
    p = {"w": (rng.normal(size=(24, 10)) * 0.2).astype(np.float32),
         "b": rng.normal(size=(10,)).astype(np.float32)}
    comp = _jax_comp(p["w"], CODEBOOKS[5])
    jq = getattr(jL.QuantConfig, quant)()
    tq = getattr(tL.QuantConfig, quant)()
    want = jL.apply_dense(p, jnp.asarray(x), qcfg=jq, comp=comp,
                          activation=activation)
    got = tL.apply_dense(j2t(p), t(x), qcfg=tq, comp=j2t(comp),
                         activation=activation)
    _close(got, want)


@pytest.mark.parametrize("train", [False, True])
def test_apply_batchnorm_matches(train):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 5, 5, 6)).astype(np.float32) * 2 + 1
    p = {"scale": rng.normal(size=(6,)).astype(np.float32),
         "bias": rng.normal(size=(6,)).astype(np.float32)}
    s = {"mean": rng.normal(size=(6,)).astype(np.float32),
         "var": rng.uniform(0.5, 2, size=(6,)).astype(np.float32)}
    y_j, s_j = jL.apply_batchnorm(p, s, jnp.asarray(x), train=train)
    y_t, s_t = tL.apply_batchnorm(j2t(p), j2t(s), t(x), train=train)
    _close(y_t, y_j)
    for k in s_j:
        _close(s_t[k], s_j[k])


def test_pools_match():
    x = np.random.default_rng(6).normal(size=(2, 9, 8, 3)).astype(np.float32)
    _close(tL.max_pool(t(x)), jL.max_pool(jnp.asarray(x)))
    _close(tL.avg_pool_global(t(x)), jL.avg_pool_global(jnp.asarray(x)))
