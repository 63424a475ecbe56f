"""The tensor-parallel building blocks of `repro_torch.distributed.sharding`
in one process (a model group of one rank, so every collective returns its
input): how a sub-module's column-parallel products send their input
gradient to the one `copy_to_model` copy, the activation fake-quant's
refusal of per-token scales on split features, the RG-LRU's
reduce-scattered gate product and the LM loss (one function, split or
not). The four-rank checks are in `tests/test_torch_mesh2d.py`."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.distributed import sharding as S
from repro_torch.nn.layers import QuantConfig, lm_fake_quant_act

SPLIT = S.ModelSplit(axes=("model",), group=None, index=0, size=1, act=None)


def arrays(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    ws = [rng.standard_normal((24, n)).astype(np.float32) for n in (16, 8)]
    gs = [rng.standard_normal((2, 5, n)).astype(np.float32) for n in (16, 8)]
    return x, ws, gs


def test_column_products_sum_their_input_gradient_once_in_float64():
    """Two column products reading one fake-quantized input: the forward
    is each correctly rounded product; the input's gradient is both
    products' float64 gradients summed, then rounded once."""
    x, ws, gs = arrays()
    xt = torch.tensor(x, requires_grad=True)
    shared = S.copy_to_model(xt, SPLIT, exact=True)
    assert shared.dtype == torch.float64
    xq = xt + (torch.round(xt * 4) / 4 - xt).detach()     # a fake-quant
    ys = [S.tp_matmul(S.read_as(xq, shared), torch.tensor(w), SPLIT,
                      "column", True) for w in ws]
    xq64 = np.round(x.astype(np.float64) * 4) / 4
    for y, w in zip(ys, ws):
        assert y.dtype == torch.float32
        np.testing.assert_array_equal(
            y.detach().numpy(), (xq64 @ w.astype(np.float64))
            .astype(np.float32))
    sum(((y * torch.tensor(g)).sum() for y, g in zip(ys, gs))).backward()
    want = sum(g.astype(np.float64) @ w.astype(np.float64).T
               for g, w in zip(gs, ws)).astype(np.float32)
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_column_product_without_exact_keeps_the_input_dtype():
    x, ws, gs = arrays(1)
    xt = torch.tensor(x, requires_grad=True)
    shared = S.copy_to_model(xt, SPLIT)
    assert shared.dtype == torch.float32
    y = S.tp_matmul(S.read_as(xt, shared), torch.tensor(ws[0]), SPLIT,
                    "column", False)
    (y * torch.tensor(gs[0])).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gs[0] @ ws[0].T, rtol=1e-5,
                               atol=1e-5)


def test_split_activation_with_per_token_scales_raises():
    """A per-token scale (``batch_invariant``) on features split over the
    model ranks would take each rank's amax alone: refused."""
    x = torch.ones(2, 3, 4)
    qcfg = dataclasses.replace(QuantConfig.on(), batch_invariant=True)
    with pytest.raises(NotImplementedError, match="per-token"):
        lm_fake_quant_act(x, qcfg, SPLIT)
    # computed whole, the per-token scale stays
    assert lm_fake_quant_act(x, qcfg).shape == x.shape


def test_row_scatter_product_is_the_correctly_rounded_product():
    """The RG-LRU's gate product (``row_scatter``) on a model group of one:
    the forward is the float64 product rounded once, the gradients the
    float64 sums rounded once."""
    x, ws, gs = arrays(2)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(ws[0], requires_grad=True)
    y = S.tp_matmul(xt, wt, SPLIT, "row_scatter", True)
    x64, w64 = x.astype(np.float64), ws[0].astype(np.float64)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  (x64 @ w64).astype(np.float32))
    (y * torch.tensor(gs[0])).sum().backward()
    g64 = gs[0].astype(np.float64)
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  (g64 @ w64.T).astype(np.float32))
    np.testing.assert_array_equal(
        wt.grad.numpy(), (x64.reshape(-1, 24).T @ g64.reshape(-1, 16))
        .astype(np.float32))


def test_loss_split_or_not_is_the_log_softmax_nll():
    """`vocab_parallel_nll` without a split (the unmeshed loss, the same
    function as the split one): -log_softmax at the label and its
    gradient softmax - onehot, within float32 rounding."""
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    labels = rng.integers(0, 64, (2, 5))
    lt = torch.tensor(logits, requires_grad=True)
    nll = S.vocab_parallel_nll(lt, torch.tensor(labels), None)
    want = -torch.gather(torch.log_softmax(torch.tensor(logits).double(),
                                           -1),
                         -1, torch.tensor(labels)[..., None])[..., 0]
    np.testing.assert_allclose(nll.detach().numpy(), want.numpy(),
                               rtol=1e-6)
    nll.sum().backward()
    soft = torch.softmax(torch.tensor(logits).double(), -1).numpy()
    soft[np.arange(2)[:, None], np.arange(5)[None, :], labels] -= 1
    np.testing.assert_allclose(lt.grad.numpy(), soft, rtol=0, atol=1e-6)
