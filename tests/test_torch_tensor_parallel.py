"""The tensor-parallel building blocks of `repro_torch.distributed.sharding`
in one process (a model group of one rank, so every collective returns its
input): how a sub-module's column-parallel products send their input
gradient to the one `copy_to_model` copy, and the activation fake-quant's
refusal of per-token scales on split features. The four-rank checks are
in `tests/test_torch_mesh2d.py`."""

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
