"""K3, the fused weight fake-quant, in the port against the JAX package.

The port's plain version (what CPU tensors run, and what the CUDA kernel is
held against on the card) must equal the JAX package's Pallas kernel in
interpret mode and its oracle ``fake_quant_ref`` **exactly**: every step is
an exactly rounded float32 operation or an integer one. With MSR truncation
(which the JAX kernel does not take) it must equal the JAX QAT chain,
`repro.core.qat.fake_quant_weight`, exactly. The straight-through gradient
is ``g * mask``. Inputs are made with numpy and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qat as jqat
from repro.kernels.fake_quant.ops import fake_quant_project as j_project
from repro.kernels.fake_quant.ops import ste_fake_quant as j_ste
from repro.kernels.fake_quant.ref import fake_quant_ref as j_ref
from repro_torch.core import qat as tqat
from repro_torch.kernels.fake_quant import fake_quant as tkernel
from repro_torch.kernels.fake_quant import ops


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(m, n, k_valid, seed):
    rng = np.random.default_rng([m, n, k_valid, seed])
    w = (rng.normal(size=(m, n)) * 0.1).astype(np.float32)
    mask = (rng.uniform(size=(m, n)) > 0.3).astype(np.float32)
    scale = np.asarray(jqat.weight_scale(jnp.asarray(w))[0])
    values = sorted(np.random.RandomState(k_valid).choice(
        np.arange(-127, 128), size=max(k_valid, 1), replace=False).tolist())
    cb = np.asarray(jqat.make_codebook(values)[0])
    return w, mask, scale, cb


def _both(w, mask, scale, cb, k):
    """(port's plain K3, JAX kernel in interpret mode, JAX oracle)."""
    before = tkernel.launches
    port = ops.fake_quant_project(_t(w), _t(mask), _t(scale), _t(cb), k)
    assert tkernel.launches == before            # CPU tensors: plain version
    args = (jnp.asarray(w), jnp.asarray(mask), jnp.asarray(scale),
            jnp.asarray(cb), jnp.asarray(k, jnp.int32))
    kernel = j_project(*args, block_m=64, block_n=64, interpret=True)
    return port.numpy(), np.asarray(kernel), np.asarray(j_ref(*args))


@pytest.mark.parametrize("m,n", [(256, 256), (100, 300), (64, 80)])
@pytest.mark.parametrize("k_valid", [0, 5, 16])
def test_plain_k3_equals_jax_kernel_and_oracle(m, n, k_valid):
    w, mask, scale, cb = _case(m, n, k_valid, 0)
    port, kernel, oracle = _both(w, mask, scale, cb, k_valid)
    assert port.dtype == np.float32 and port.shape == (m, n)
    np.testing.assert_array_equal(port, kernel)
    np.testing.assert_array_equal(port, oracle)


def test_plain_k3_ties():
    """w / scale exactly at x.5 (round half to even) and integers exactly
    halfway between two codebook entries (the lower index wins)."""
    n = 8
    halves = np.arange(-40, 40, dtype=np.float32) + 0.5       # x.5 exactly
    w = np.concatenate([halves, np.arange(-40, 40, dtype=np.float32)])
    w = np.resize(w, (len(w) // n, n))
    mask = np.ones_like(w)
    scale = np.ones(n, np.float32)
    cb = np.asarray(jqat.make_codebook([-30, -10, 0, 10, 30])[0])
    for k in (0, 3, 5):
        port, kernel, oracle = _both(w, mask, scale, cb, k)
        np.testing.assert_array_equal(port, kernel)
        np.testing.assert_array_equal(port, oracle)
    port, _, _ = _both(w, mask, scale, cb, 5)
    q = {float(a): float(b) for a, b in zip(w.reshape(-1), port.reshape(-1))}
    assert q[2.5] == 0.0 and q[3.5] == 0.0     # 2 and 4 round to 0
    assert q[5.0] == 0.0 and q[-5.0] == -10.0  # ties keep the lower entry
    assert q[20.0] == 10.0 and q[-20.0] == -30.0


def test_plain_k3_clips_before_projecting():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(32, 16)).astype(np.float32) * 4.0
    mask = np.ones_like(w)
    scale = np.full(16, 0.01, np.float32)       # |w / scale| up to ~1000
    cb = np.asarray(jqat.make_codebook([-127, -100, 0, 100, 126])[0])
    for k in (0, 5):
        port, kernel, oracle = _both(w, mask, scale, cb, k)
        np.testing.assert_array_equal(port, kernel)
        np.testing.assert_array_equal(port, oracle)
    port, _, _ = _both(w, mask, scale, cb, 0)
    assert np.abs(port / 0.01).max() == pytest.approx(127.0)


@pytest.mark.parametrize("bits", [1, 3, 5])
@pytest.mark.parametrize("shape", [(64, 48), (3, 3, 8, 16)])
def test_msr_chain_equals_jax_qat(bits, shape):
    """With MSR truncation, the port's K3 (through `qat.fake_quant_weight`
    and directly) equals the JAX QAT chain bit for bit."""
    rng = np.random.default_rng(bits)
    w = (rng.normal(size=shape) * 0.2).astype(np.float32)
    mask = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    values = [-96, -40, -8, 0, 8, 40, 96]
    jcomp = jqat.identity_comp(shape)
    jcomp["mask"] = jnp.asarray(mask)
    jcomp["codebook"], jcomp["codebook_k"] = jqat.make_codebook(values)
    jcomp["msr_bits"] = jnp.asarray(bits, jnp.int32)
    tcomp = {k: _t(v) for k, v in jax.device_get(jcomp).items()}

    got = tqat.fake_quant_weight(_t(w), tcomp).numpy()
    want = np.asarray(jqat.fake_quant_weight(jnp.asarray(w), jcomp))
    np.testing.assert_array_equal(got, want)

    n = shape[-1]
    wm = w * mask
    scale = np.asarray(jqat.weight_scale(jnp.asarray(wm))).reshape(-1)
    q_int = np.asarray(jqat.quantize_weight_int(jnp.asarray(w), jcomp))
    direct = ops.fake_quant_project(
        _t(w.reshape(-1, n)), _t(mask.reshape(-1, n)), _t(scale),
        tcomp["codebook"], tcomp["codebook_k"], tcomp["msr_bits"])
    np.testing.assert_array_equal(
        direct.numpy(), q_int.reshape(-1, n).astype(np.float32) * scale)


def test_ste_gradient_is_masked_passthrough():
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(64, 64)) * 0.1).astype(np.float32)
    mask = (rng.uniform(size=(64, 64)) > 0.5).astype(np.float32)
    scale = np.asarray(jqat.weight_scale(jnp.asarray(w))[0])
    cb, k = jqat.make_codebook([-64, -16, 0, 16, 64])

    tw = _t(w).requires_grad_(True)
    out = ops.ste_fake_quant(tw, _t(mask), _t(scale), _t(cb), int(k))
    (out * 2.0).sum().backward()
    np.testing.assert_array_equal(tw.grad.numpy(), 2.0 * mask)

    jg = jax.grad(lambda v: jnp.sum(j_ste(v, jnp.asarray(mask),
                                          jnp.asarray(scale), cb, k) * 2.0))(
        jnp.asarray(w))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(
        j_project(jnp.asarray(w), jnp.asarray(mask), jnp.asarray(scale), cb,
                  k, interpret=True)))


def _good():
    w = torch.zeros((4, 3))
    return dict(w=w, mask=torch.ones((4, 3)), scale=torch.ones(3),
                codebook=torch.zeros(32, dtype=torch.int32), k=0, msr_bits=0)


@pytest.mark.parametrize("field,value,match", [
    ("w", torch.zeros(12), "2-D"),
    ("w", torch.zeros((4, 3), dtype=torch.float64), "float32"),
    ("w", torch.zeros((3, 4)).T, "contiguous"),
    ("mask", torch.ones((4, 3), dtype=torch.int32), "mask must be"),
    ("mask", torch.ones((4, 4)), "mask shape"),
    ("scale", torch.ones(4), "scale shape"),
    ("scale", torch.ones(3, dtype=torch.float64), "scale must be"),
    ("codebook", torch.zeros(16, dtype=torch.int32), "codebook shape"),
    ("codebook", torch.zeros(32), "codebook must be int32"),
    ("k", 33, r"k=33 not in \[0, 32\]"),
    ("k", -1, r"k=-1"),
    ("k", torch.tensor(40, dtype=torch.int32), "k=40"),
    ("k", torch.zeros(1, dtype=torch.int32), "0-d int32"),
    ("k", 2.0, "int or a 0-d"),
    ("msr_bits", 9, r"msr_bits=9 not in \[0, 8\]"),
    ("msr_bits", torch.tensor(-2, dtype=torch.int32), "msr_bits=-2"),
])
def test_input_checks_raise(field, value, match):
    args = _good()
    ops.fake_quant_project(**args)
    args[field] = value
    with pytest.raises(ValueError, match=match):
        ops.fake_quant_project(**args)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.launch(**_good())
