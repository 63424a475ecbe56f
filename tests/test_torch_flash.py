"""Port parity for the flash-attention backward (`repro_torch.nn.flash`):
its forward against the port's blocked attention, its gradients against
autograd through the blocked attention, both against the JAX package's
`flash_attention` and ``jax.grad`` on the same arrays, and whole-model
gradients with flash on and off.

Tolerances and why (measured gaps on this host in parentheses):
  * forward against the blocked path: equal (the same operations on the
    same blocks in the same order);
  * gradients against autograd through the blocked path: rel-L2 1e-5
    (~3e-7: the backward recomputes the probabilities from the saved
    log-sum-exp instead of keeping the online-softmax tiles, float32
    round-off);
  * forward and gradients against the JAX package's flash on the same
    arrays: abs 1e-5 on values of order 1 (forward 6.0e-7, gradients
    1.4e-6: float32 summation orders of the two libraries' products);
  * whole-model loss and gradients with flash on and off: the JAX test's
    bounds (loss abs 1e-5, gradients abs 1e-3; ~1e-7 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.flash import flash_attention as j_flash
from repro_torch._device import tree_leaves, tree_unflatten
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import build_lm
from repro_torch.nn.attention import AttnDims, blocked_attention
from repro_torch.nn.flash import flash_attention
from repro_torch.nn.spec import init_params

BLOCK = 8
CASES = [(c, w, hkv, g) for c, w in ((True, 0), (True, 12), (False, 0))
         for hkv, g in ((2, 1), (1, 4), (2, 2))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work in this file runs on one thread: beside the
    suite's parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, b=2, s=32, hkv=2, g=2, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hkv * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    t = rng.standard_normal((b, s, hkv * g, hd)).astype(np.float32)
    return q, k, v, t


def _dims(causal, window, hkv, g, hd=16):
    return AttnDims(d_model=hkv * g * hd, n_heads=hkv * g, n_kv_heads=hkv,
                    head_dim=hd, causal=causal, window=window)


def _grads(q, k, v, tangent, dims, flash):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = blocked_attention(*ts, dims, q_block=BLOCK, kv_block=BLOCK,
                            use_flash=flash)
    (out * torch.as_tensor(tangent)).sum().backward()
    return out.detach(), [t.grad for t in ts]


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("causal,window,hkv,g", CASES)
def test_flash_forward_and_grads_match_blocked(causal, window, hkv, g):
    q, k, v, t = _case(hkv * 10 + g + window, hkv=hkv, g=g)
    dims = _dims(causal, window, hkv, g)
    out_ref, g_ref = _grads(q, k, v, t, dims, False)
    out_fl, g_fl = _grads(q, k, v, t, dims, True)
    assert torch.equal(out_fl, out_ref)
    for a, b_, name in zip(g_fl, g_ref, "qkv"):
        assert rel_l2(a.numpy(), b_.numpy()) < 1e-5, f"d{name}"


@pytest.mark.parametrize("causal,window,hkv,g", CASES)
def test_flash_matches_jax_flash_and_grad(causal, window, hkv, g):
    q, k, v, t = _case(hkv * 7 + g + window, hkv=hkv, g=g)
    b, s, hq, hd = q.shape
    pos = np.arange(s, dtype=np.int32)

    def j_loss(q, k, v):
        out = j_flash(q.reshape(b, s, hkv, g, hd), k, v, jnp.asarray(pos),
                      jnp.asarray(pos), causal, window, BLOCK, BLOCK)
        return jnp.sum(out.reshape(b, s, hq, hd) * t), out

    (_, j_out), j_g = jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = flash_attention(ts[0].reshape(b, s, hkv, g, hd), ts[1], ts[2],
                          torch.as_tensor(pos), torch.as_tensor(pos), causal,
                          window, BLOCK, BLOCK)
    (out.reshape(b, s, hq, hd) * torch.as_tensor(t)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=0, atol=1e-5)
    for a, b_, name in zip(ts, j_g, "qkv"):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b_), rtol=0,
                                   atol=1e-5, err_msg=f"d{name}")


def test_flash_model_level_grads():
    """Whole-model gradients with flash on and off agree (the JAX test's
    model: a local/global pattern, GQA, remat)."""
    cfg = ArchConfig(name="t", family="dense", n_layers=3, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab=300,
                     head_dim=16, pattern=("local", "attn"), window=16,
                     compute_dtype="float32")
    m = build_lm(cfg)
    params = init_params(0, m.spec, "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, 300, (2, 24)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def loss_and_grads(flash):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, _ = m.loss(tree_unflatten(params, iter(leaves)), batch,
                         q_block=8, kv_block=8, use_flash=flash, remat=True)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    l0, g0 = loss_and_grads(False)
    l1, g1 = loss_and_grads(True)
    assert abs(l0 - l1) < 1e-5
    assert max(float((a - b_).abs().max()) for a, b_ in zip(g0, g1)) < 1e-3


def test_flash_rejects_per_sequence_positions():
    q, k, v, _ = _case(3)
    dims = _dims(True, 0, 2, 2)
    pos = torch.arange(32, dtype=torch.int32).expand(2, 32)
    with pytest.raises(ValueError, match="per-sequence"):
        blocked_attention(*(torch.as_tensor(a) for a in (q, k, v)), dims,
                          q_block=BLOCK, kv_block=BLOCK, q_positions=pos,
                          kv_positions=pos, use_flash=True)


def test_softcap_keeps_the_autograd_path():
    q, k, v, t = _case(4)
    dims = AttnDims(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                    softcap=30.0)
    out_ref, g_ref = _grads(q, k, v, t, dims, False)
    out_fl, g_fl = _grads(q, k, v, t, dims, True)
    assert torch.equal(out_fl, out_ref)
    for a, b_ in zip(g_fl, g_ref):
        assert torch.equal(a, b_)
