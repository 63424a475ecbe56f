"""Port parity for the LUT-GEMM kernel module (`repro_torch.kernels.lut_matmul`).

The plain PyTorch version (``ref.py``, what CPU tensors run) is held against
the JAX package's Pallas kernel in interpret mode and its jnp oracle, across
activations, bias/residual, ``block_k`` multiples of the pack block and
ragged N: rtol/atol 1e-5, float32 summation order only. Encoding and packing
must be bit-exact. X may be unpadded (K_x = K rounded up to 8 columns, not
the pack block's K_pad): the plain version then equals the padded call bit
for bit. The CUDA kernel itself runs only on the card (``chip_smoke.py``
holds it against ``ref.py`` there); here the wrapper's input checks are
exercised, which run before any dispatch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lut_matmul import ops as jops
from repro.kernels.lut_matmul.lut_matmul import lut_matmul_pallas
from repro.kernels.lut_matmul.ref import lut_matmul_fused_ref as j_fused_ref
from repro.kernels.lut_matmul.ref import unpack_indices as j_unpack
from repro.core import qat as jqat
from repro_torch.core.export import serve_dense
from repro_torch.kernels.lut_matmul import lut_matmul as tkernel
from repro_torch.kernels.lut_matmul import ops as tops
from repro_torch.kernels.lut_matmul import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)
VALUES = [-112, -80, -56, -40, -28, -16, -8, 0, 8, 16, 28, 40, 56, 80, 112,
          127]


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def problem(m, k, n, *, pack_block=128, seed=0):
    """Same numpy inputs for both packages: weights packed by the JAX
    encoder, x / bias / residual from one rng."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    packed, cb, scale = jops.compress_layer_weights(
        jnp.asarray(w), VALUES, block_k=pack_block)
    arrs = dict(x=rng.normal(size=(m, k)).astype(np.float32),
                packed=np.asarray(packed), cb=np.asarray(cb),
                scale=np.asarray(scale),
                bias=(rng.normal(size=(n,)) * 0.1).astype(np.float32),
                res=rng.normal(size=(m, n)).astype(np.float32))
    return arrs


def port_fused(a, *, with_bias, with_res, activation, pack_block=128):
    return tops.lut_matmul_fused(
        t(a["x"]), t(a["packed"]), t(a["cb"]), t(a["scale"]),
        bias=t(a["bias"]) if with_bias else None,
        residual=t(a["res"]) if with_res else None,
        activation=activation, pack_block=pack_block)


def jax_kwargs(a, with_bias, with_res, activation):
    return dict(bias=jnp.asarray(a["bias"]) if with_bias else None,
                residual=jnp.asarray(a["res"]) if with_res else None,
                activation=activation)


# -------------------------------------------------------- plain version parity


@pytest.mark.parametrize("activation", ["none", "relu", "gelu", "silu"])
@pytest.mark.parametrize("with_bias,with_res", [(False, False), (True, False),
                                                (False, True), (True, True)])
@pytest.mark.parametrize("block_k_mult", [1, 2])
def test_ref_matches_pallas_interpret(activation, with_bias, with_res,
                                      block_k_mult):
    pack_block = 64
    a = problem(16, 256, 64, pack_block=pack_block)
    kw = jax_kwargs(a, with_bias, with_res, activation)
    want_kernel = lut_matmul_pallas(
        jnp.asarray(a["x"]), jnp.asarray(a["packed"]), jnp.asarray(a["cb"]),
        jnp.asarray(a["scale"]), block_m=16, block_n=64,
        block_k=pack_block * block_k_mult, pack_block=pack_block,
        interpret=True, **kw)
    want_oracle = j_fused_ref(jnp.asarray(a["x"]), jnp.asarray(a["packed"]),
                              jnp.asarray(a["cb"]), jnp.asarray(a["scale"]),
                              block_k=pack_block, **kw)
    got = port_fused(a, with_bias=with_bias, with_res=with_res,
                     activation=activation, pack_block=pack_block)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_oracle), **TOL)


@pytest.mark.parametrize("m,n", [(13, 40), (37, 10), (8, 130)])
def test_ref_matches_padded_wrapper_ragged(m, n):
    """Ragged M and N: the JAX wrapper pads to blocks, the port's kernel
    masks edges; both equal the unpadded product."""
    a = problem(m, 256, n, seed=m + n)
    kw = jax_kwargs(a, True, True, "gelu")
    want = jops.lut_matmul_fused(
        jnp.asarray(a["x"]), jnp.asarray(a["packed"]), jnp.asarray(a["cb"]),
        jnp.asarray(a["scale"]), block_m=16, block_n=128, block_k=128,
        interpret=True, **kw)
    got = port_fused(a, with_bias=True, with_res=True, activation="gelu")
    assert tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_x_matches_oracle():
    a = problem(16, 128, 32, seed=3)
    xb = jnp.asarray(a["x"]).astype(jnp.bfloat16)
    want = j_fused_ref(xb, jnp.asarray(a["packed"]), jnp.asarray(a["cb"]),
                       jnp.asarray(a["scale"]), activation="silu")
    got = tops.lut_matmul_fused(
        t(a["x"]).to(torch.bfloat16), t(a["packed"]), t(a["cb"]),
        t(a["scale"]), activation="silu")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k", [32, 144, 288, 576])
def test_ref_unpadded_x_equals_padded_call(k):
    """X with K_x = K columns (the serve path's rows; each K here is already
    a multiple of 8) gives the padded (M, K_pad) call's result bit for bit,
    with every epilogue input, against weights whose padding rows are not
    zero weights (no 0 in the codebook)."""
    rng = np.random.default_rng(k)
    m, n = 24, 16
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    packed, cb, scale = tops.compress_layer_weights(
        t(w), [-120, -80, -45, -20, -5], pad_k=True)
    k_pad = 2 * packed.shape[0]
    assert k_pad > k and int(cb[int(torch.argmin(cb.abs()))]) != 0
    x = rng.normal(size=(m, k)).astype(np.float32)
    x_pad = np.zeros((m, k_pad), np.float32)
    x_pad[:, :k] = x
    kw = dict(bias=t(rng.normal(size=(n,)).astype(np.float32)),
              residual=t(rng.normal(size=(m, n)).astype(np.float32)),
              activation="relu")
    got = tops.lut_matmul_fused(t(x), packed, cb, scale, **kw)
    want = tops.lut_matmul_fused(t(x_pad), packed, cb, scale, **kw)
    assert torch.equal(got, want)
    assert torch.equal(tref.lut_matmul_ref(t(x), packed, cb, scale),
                       tref.lut_matmul_ref(t(x_pad), packed, cb, scale))


def test_ref_x_past_k_pad_meets_zero_weights():
    """A pack block that is not a multiple of 8 can leave K_pad below K
    rounded up to 8; X's columns past K_pad then multiply zero weights."""
    rng = np.random.default_rng(6)
    w = (rng.normal(size=(27, 5)) * 0.05).astype(np.float32)
    packed, cb, scale = tops.compress_layer_weights(t(w), VALUES, block_k=6,
                                                    pad_k=True)
    assert 2 * packed.shape[0] == 30
    x = np.zeros((7, 32), np.float32)
    x[:, :27] = rng.normal(size=(7, 27))
    got = tops.lut_matmul_fused(t(x), packed, cb, scale, pack_block=6)
    want = tref.exact_matmul(t(x[:, :30]), tref.dequantize(packed, cb, scale,
                                                           6))
    assert torch.equal(got, want)


def test_epilogue_order_bias_act_then_residual():
    a = problem(8, 128, 16, seed=4)
    base = tref.lut_matmul_ref(t(a["x"]), t(a["packed"]), t(a["cb"]),
                               t(a["scale"]))
    got = port_fused(a, with_bias=True, with_res=True, activation="relu")
    want = torch.relu(base + t(a["bias"])) + t(a["res"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_cpu_dispatch_is_the_plain_version():
    a = problem(16, 256, 24, seed=5)
    got = port_fused(a, with_bias=True, with_res=False, activation="silu")
    want = tref.lut_matmul_fused_ref(t(a["x"]), t(a["packed"]), t(a["cb"]),
                                     t(a["scale"]), bias=t(a["bias"]),
                                     activation="silu")
    assert torch.equal(got, want)
    bare = tops.lut_matmul(t(a["x"]), t(a["packed"]), t(a["cb"]),
                           t(a["scale"]), block_k=128)
    assert torch.equal(bare, tref.lut_matmul_ref(
        t(a["x"]), t(a["packed"]), t(a["cb"]), t(a["scale"]), block_k=128))


# ------------------------------------------------- encode / pack, bit-exact


def test_encode_weights_duplicates_lowest_index():
    cb = np.asarray([-40, -40, 0, 10, 10, 10] + [10] * 10, np.int32)
    w = np.asarray([[-40, -39, 0, 10, 10, 7]], np.int32)
    want = jops.encode_weights(jnp.asarray(w), jnp.asarray(cb))
    got = tops.encode_weights(t(w), t(cb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 0]) == 0 and int(got[0, 3]) == 3


@pytest.mark.parametrize("block_k", [2, 16, 128])
def test_pack_unpack_bit_exact(block_k):
    idx = np.random.default_rng(block_k).integers(0, 16, size=(256, 12),
                                                   dtype=np.int32)
    want = jops.pack_indices(jnp.asarray(idx), block_k)
    got = tops.pack_indices(t(idx), block_k)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tref.unpack_indices(got, block_k).numpy(),
                                  np.asarray(j_unpack(want, block_k)))
    np.testing.assert_array_equal(tref.unpack_indices(got, block_k).numpy(),
                                  idx)


CASES = {
    "symmetric": dict(values=VALUES),
    "duplicates": dict(values=[-40, -40, 0, 10, 10, 10]),
    "all_negative": dict(values=[-120, -80, -45, -20, -5]),
    "mask_forces_zero": dict(values=[-90, -30, 40, 110], prune=0.5),
    "msr": dict(values=VALUES, msr=3, prune=0.3),
    "pad_k": dict(values=[-96, -32, 0, 64], k=200, pad_k=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_layer_weights_bit_exact(case):
    c = CASES[case]
    k = c.get("k", 128)
    rng = np.random.default_rng(len(case))
    w = (rng.normal(size=(k, 24)) * 0.05).astype(np.float32)
    mask = None
    if c.get("prune"):
        mask = np.asarray(jqat.magnitude_prune_mask(jnp.asarray(w), c["prune"]))
    kw = dict(msr_bits=c.get("msr", 0), block_k=128,
              pad_k=c.get("pad_k", False))
    want = jops.compress_layer_weights(
        jnp.asarray(w), c["values"],
        mask=None if mask is None else jnp.asarray(mask), **kw)
    got = tops.compress_layer_weights(
        t(w), c["values"], mask=None if mask is None else t(mask), **kw)
    for g, wv in zip(got, want):
        assert g.dtype == getattr(torch, str(np.asarray(wv).dtype))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    if mask is not None:
        idx = tref.unpack_indices(got[0], 128)[:k]
        served = got[1].to(torch.int32)[idx.long()]
        assert (served[t(mask) == 0] == 0).all()


def test_compress_layer_weights_rejects_full_codebook_plus_zero():
    gen = torch.Generator().manual_seed(3)
    w = torch.randn(128, 16, generator=gen) * 0.05
    mask = torch.ones_like(w)
    mask[0, 0] = 0
    full = [v for v in VALUES if v != 0] + [120]
    with pytest.raises(ValueError, match="forced 0"):
        tops.compress_layer_weights(w, full, mask=mask)
    with pytest.raises(ValueError, match="empty"):
        tops.compress_layer_weights(w, [])


# ------------------------------------------------------ wrapper input checks


def _good(m=8, k=128, n=16):
    return (torch.zeros(m, k), torch.zeros(k // 2, n, dtype=torch.int8),
            torch.zeros(16, dtype=torch.int8), torch.ones(n))


@pytest.mark.parametrize("bad,match", [
    ("k_pairing", "does not pair"),
    ("k_x_over_k_pad", "does not pair"),
    ("odd_pack_block", "positive even"),
    ("k_not_multiple", "multiple of 8"),
    ("k_pad_not_multiple", "multiple of pack_block"),
    ("activation", "unknown activation"),
    ("bias_shape", "bias shape"),
    ("residual_shape", "residual shape"),
    ("x_dtype", "float32 or bfloat16"),
    ("packed_dtype", "packed must be"),
    ("codebook_dtype", "codebook must be"),
    ("x_strided", "contiguous"),
    ("residual_strided", "contiguous"),
    ("device_mismatch", "is on"),
])
def test_wrapper_rejects_bad_inputs(bad, match):
    x, packed, cb, scale = _good()
    kw = dict(bias=None, residual=None, activation="none", pack_block=128)
    if bad == "k_pairing":
        packed = torch.zeros(32, 16, dtype=torch.int8)
    elif bad == "odd_pack_block":
        kw["pack_block"] = 127
    elif bad == "k_x_over_k_pad":
        x = torch.zeros(8, 136)
    elif bad == "k_not_multiple":
        x = torch.zeros(8, 100)
    elif bad == "k_pad_not_multiple":
        x, packed = torch.zeros(8, 96), torch.zeros(50, 16, dtype=torch.int8)
    elif bad == "activation":
        kw["activation"] = "tanh"
    elif bad == "bias_shape":
        kw["bias"] = torch.zeros(15)
    elif bad == "residual_shape":
        kw["residual"] = torch.zeros(8, 15)
    elif bad == "x_dtype":
        x = x.double()
    elif bad == "packed_dtype":
        packed = packed.to(torch.uint8)
    elif bad == "codebook_dtype":
        cb = cb.to(torch.int32)
    elif bad == "x_strided":
        x = torch.zeros(128, 8).T            # (8, 128) view, not row-major
    elif bad == "residual_strided":
        kw["residual"] = torch.zeros(16, 8).T
    elif bad == "device_mismatch":
        kw["bias"] = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match=match):
        tops.lut_matmul_fused(x, packed, cb, scale, **kw)


def test_kernel_launch_refuses_cpu_tensors():
    """The CUDA launch never computes on the CPU in its place."""
    x, packed, cb, scale = _good()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.launch(x, packed, cb, scale)
    assert tkernel.launches == 0


def test_serve_dense_builds_contiguous_rows_for_the_kernel():
    """A strided activation view is refused by the wrapper but served by
    `serve_dense`, which builds the contiguous (M, K_x) matrix explicitly
    (K_x = K rounded up to 8, not the pack block's K_pad)."""
    from repro_torch.core import qat as tqat
    from repro_torch.core.export import export_layer

    gen = torch.Generator().manual_seed(4)
    w = torch.randn(40, 12, generator=gen) * 0.05
    comp = tqat.identity_comp(w.shape, device="cpu")
    comp["codebook"], comp["codebook_k"] = tqat.make_codebook(VALUES,
                                                              device="cpu")
    art = export_layer(w, comp)
    x = torch.randn(40, 6, generator=gen).T       # (6, 40), strided
    assert not x.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        tops.lut_matmul_fused(x, art.packed[:20], art.codebook, art.scale,
                              pack_block=40)
    got = serve_dense(x, art)
    want = x @ tqat.fake_quant_weight(w, comp)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("k", [27, 40, 100])
def test_serve_dense_feeds_round_up_8_rows(k, monkeypatch):
    """`serve_dense` hands the kernel contiguous (M, round_up(K, 8)) rows,
    zero past K, never the pack block's K_pad."""
    from repro_torch.core import export as texport
    from repro_torch.core import qat as tqat

    seen = []
    real = texport.lut_matmul_fused

    def spy(x, *a, **kw):
        seen.append(x)
        return real(x, *a, **kw)

    monkeypatch.setattr(texport, "lut_matmul_fused", spy)
    gen = torch.Generator().manual_seed(k)
    w = torch.randn(k, 12, generator=gen) * 0.05
    comp = tqat.identity_comp(w.shape, device="cpu")
    comp["codebook"], comp["codebook_k"] = tqat.make_codebook(VALUES,
                                                              device="cpu")
    art = texport.export_layer(w, comp)
    x = torch.randn(2, 3, k, generator=gen)
    got = texport.serve_dense(x, art)
    rows, = seen
    k_x = -(-k // 8) * 8
    assert tuple(rows.shape) == (6, k_x) == (6, art.k_x) and art.k_pad == 128
    assert rows.is_contiguous() and not rows[:, k:].any()
    assert torch.equal(rows[:, :k], x.reshape(6, k))
    # the product of the weight the artifact carries, which is what
    # serve_dense computes; the straight-through fake-quant value
    # wm + (wq - wm) is not always wq in float32, but within one ulp of it
    w_art = tref.dequantize(art.packed, art.codebook, art.scale,
                            art.block_k)[:k]
    assert torch.equal(got.reshape(6, 12),
                       tref.exact_matmul(x.reshape(6, k), w_art))
    fq = tqat.fake_quant_weight(w, comp)
    inf = torch.full_like(w_art, float("inf"))
    assert ((fq == w_art) | (fq == torch.nextafter(w_art, inf))
            | (fq == torch.nextafter(w_art, -inf))).all()
