"""Port parity for checkpointing (`repro_torch.checkpoint.CheckpointManager`):
the JAX package's four manager tests as port tests (roundtrip, keep and
latest, async saves safe from later mutation, a stale ``.tmp`` ignored),
checkpoints crossing between the packages both ways with equal leaves
(bfloat16 included, as raw 16-bit words), and the LM target restoring
``target.ckpt_dir``. Every comparison is exact: a checkpoint stores the
leaves' bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config as jget
from repro.models.lm import build_lm as jbuild
from repro.nn.spec import flatten_with_names as jflat
from repro.nn.spec import init_params as jinit
from repro_torch.checkpoint import CheckpointManager
from repro_torch.nn.spec import flatten_with_names as tflat
from repro_torch.pipeline.config import reduced_lm_config as t_reduced_lm
from repro_torch.pipeline.pipeline import Pipeline as TPipeline


def _toy_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 8), generator=g),
                   "b": torch.zeros((8,)),
                   "h": torch.randn((4,), generator=g).to(torch.bfloat16)},
        "opt": {"step": torch.zeros((), dtype=torch.int32)},
    }


def _assert_trees_equal(got, want):
    g, w = tflat(got), tflat(want)
    assert list(g) == list(w)
    for name in w:
        assert g[name].dtype == w[name].dtype, name
        assert g[name].shape == w[name].shape, name
        assert torch.equal(g[name], w[name]), name


def test_checkpoint_roundtrip(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2, async_save=False)
    state = _toy_state()
    ckpt.save(10, state)
    step, restored = ckpt.restore(device="cpu")
    assert step == 10
    _assert_trees_equal(restored, state)
    assert restored["opt"]["step"].shape == ()


def test_checkpoint_keep_and_latest(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ckpt.save(s, _toy_state(s))
    assert ckpt.all_steps() == [3, 4]
    assert ckpt.latest_step() == 4
    _assert_trees_equal(ckpt.restore(3, device="cpu")[1], _toy_state(3))


def test_checkpoint_async_and_mutation_safety(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=3, async_save=True)
    state = _toy_state()
    want = _toy_state()
    ckpt.save(1, state)
    # mutate right after scheduling the save, in place and by rebinding:
    # the snapshot taken at save time must be what is written
    state["params"]["w"].zero_()
    state["params"]["b"] = state["params"]["b"] + 1
    ckpt.wait()
    _, restored = ckpt.restore(1, device="cpu")
    _assert_trees_equal(restored, want)


def test_checkpoint_atomic_no_partial(tmp_path):
    ckpt = CheckpointManager(tmp_path, async_save=False)
    ckpt.save(5, _toy_state())
    # a stale tmp dir from a "crashed" save must not break restore
    (tmp_path / "step_00000009.tmp").mkdir()
    assert ckpt.latest_step() == 5
    step, _ = ckpt.restore(device="cpu")
    assert step == 5


def test_restore_of_nothing_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CheckpointManager(tmp_path).restore(device="cpu")


def _jax_words(a):
    """A JAX package leaf's bytes as numpy: bfloat16 (or what numpy reads
    back for it) as raw 16-bit words."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind in "Vf" and \
            a.dtype != np.float16:
        return a.view(np.uint16)
    return a


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    k = jax.random.PRNGKey(3)
    state = {"params": {"w": jax.random.normal(k, (8, 8)),
                        "h": jnp.linspace(-2, 2, 6).astype(jnp.bfloat16)},
             "opt": {"step": jnp.asarray(7, jnp.int32)}}
    JManager(tmp_path, async_save=False).save(4, state)
    step, got = CheckpointManager(tmp_path).restore(device="cpu")
    assert step == 4
    want, have = jflat(jax.device_get(state)), tflat(got)
    assert list(want) == list(have)
    assert have["params/h"].dtype == torch.bfloat16
    for name, a in want.items():
        t = have[name]
        words = (t.view(torch.int16).numpy().view(np.uint16)
                 if t.dtype == torch.bfloat16 else t.numpy())
        np.testing.assert_array_equal(words, _jax_words(a), err_msg=name)
        assert t.shape == tuple(np.shape(a)), name


def test_port_checkpoint_restores_in_jax(tmp_path):
    state = _toy_state(9)
    CheckpointManager(tmp_path, async_save=False).save(2, state)
    step, got = JManager(tmp_path).restore()
    assert step == 2
    have, want = jflat(got), tflat(state)
    assert list(have) == list(want)
    for name, t in want.items():
        words = (t.view(torch.int16).numpy().view(np.uint16)
                 if t.dtype == torch.bfloat16 else t.numpy())
        np.testing.assert_array_equal(_jax_words(have[name]), words,
                                      err_msg=name)


def test_lm_target_restores_a_jax_checkpoint(tmp_path):
    """``target.ckpt_dir`` holding the JAX package's train state: the
    port's profile stage serves its ``params`` subtree, leaf for leaf."""
    jm = jbuild(jget("olmo-1b").scaled_down(compute_dtype="float32"))
    params = jinit(jax.random.PRNGKey(11), jm.spec)
    JManager(tmp_path, async_save=False).save(
        30, {"params": params, "opt": {"step": jnp.asarray(30, jnp.int32)}})
    cfg = t_reduced_lm("olmo-1b").with_overrides(
        {"target": {"ckpt_dir": str(tmp_path)}})
    plan = TPipeline(cfg, device="cpu").run_until("profile")
    want, have = jflat(jax.device_get(params)), tflat(plan.params)
    assert list(want) == list(have)
    for name, a in want.items():
        np.testing.assert_array_equal(have[name].numpy(), np.asarray(a),
                                      err_msg=name)
