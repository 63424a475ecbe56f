"""K3 grouped: one fake-quant call for a whole QAT forward, against the JAX
package's per-layer `fake_quant_weight` and the port's own per-layer path.

`qat.fake_quant_weights` must equal `repro.core.qat.fake_quant_weight`
leaf by leaf **exactly** (every step is an exactly rounded float32 or an
integer operation, and the column maximum is exact in any order), and its
gradient must be each layer's mask. A QAT forward and a train step of
ResNet-8 through the grouped path must equal the per-layer path bit for
bit. Inputs are made with numpy and handed to both packages.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qat as jqat
from repro_torch._device import tree_leaves
from repro_torch.core import qat as tqat
from repro_torch.core.runner import CnnRunner
from repro_torch.kernels.fake_quant import fake_quant as tkernel
from repro_torch.kernels.fake_quant import ops
from repro_torch.nn import cnn as tcnn
from repro_torch.nn.layers import QuantConfig
from repro_torch.nn.spec import init_params


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(model, seed):
    """{layer: float32 numpy weight} of every compressible layer."""
    rng = np.random.default_rng(seed)
    out = {}
    for cl in model.comp_layers:
        shape = ((cl.kernel, cl.kernel, cl.c_in, cl.c_out)
                 if cl.kind == "conv" else (cl.c_in, cl.c_out))
        out[cl.name] = (rng.normal(size=shape) * 0.1).astype(np.float32)
    return out


def _mixed_comps(weights, seed):
    """JAX comp states cycling through identity (None), pruned 50%, a
    16-value codebook and 3 MSR bits (with a codebook), so every layer kind
    of the model meets several kinds of state."""
    rng = np.random.default_rng(seed)
    comps = {}
    for i, (name, w) in enumerate(weights.items()):
        kind = i % 4
        if kind == 0:
            comps[name] = None
            continue
        c = jqat.identity_comp(w.shape)
        if kind == 1:
            c["mask"] = jnp.asarray((rng.uniform(size=w.shape) > 0.5)
                                    .astype(np.float32))
        if kind in (2, 3):
            vals = sorted(rng.choice(np.arange(-127, 128), 16,
                                     replace=False).tolist())
            c["codebook"], c["codebook_k"] = jqat.make_codebook(vals)
        if kind == 3:
            c["msr_bits"] = jnp.asarray(3, jnp.int32)
        comps[name] = c
    return comps


def _to_torch(comp):
    return None if comp is None else {
        k: _t(v) for k, v in jax.device_get(comp).items()}


@pytest.mark.parametrize("arch", ["lenet5", "resnet8"])
def test_grouped_equals_jax_per_leaf(arch):
    model = getattr(tcnn, arch)()
    weights = _weights(model, 0)
    jcomps = _mixed_comps(weights, 1)
    names = list(weights)
    before = tkernel.launches
    got = tqat.fake_quant_weights([_t(weights[n]) for n in names],
                                  [_to_torch(jcomps[n]) for n in names])
    assert tkernel.launches == before            # CPU tensors: plain version
    assert len(got) == len(names)
    for name, g in zip(names, got):
        want = np.asarray(jqat.fake_quant_weight(jnp.asarray(weights[name]),
                                                 jcomps[name]))
        assert g.dtype == torch.float32 and g.shape == want.shape, name
        np.testing.assert_array_equal(g.numpy(), want, err_msg=name)


@pytest.mark.parametrize("arch", ["lenet5", "resnet8"])
def test_grouped_gradient_is_the_mask(arch):
    model = getattr(tcnn, arch)()
    weights = _weights(model, 2)
    jcomps = _mixed_comps(weights, 3)
    names = list(weights)
    rng = np.random.default_rng(4)
    gs = {n: rng.normal(size=w.shape).astype(np.float32)
          for n, w in weights.items()}
    ws = [_t(weights[n]).requires_grad_(True) for n in names]
    outs = tqat.fake_quant_weights(ws, [_to_torch(jcomps[n]) for n in names])
    sum((o * _t(gs[n])).sum() for o, n in zip(outs, names)).backward()
    for name, w in zip(names, ws):
        jw = jnp.asarray(weights[name])
        want = jax.grad(lambda v, n=name: jnp.sum(
            jqat.fake_quant_weight(v, jcomps[n]) * gs[n]))(jw)
        mask = (np.ones_like(weights[name]) if jcomps[name] is None
                else np.asarray(jcomps[name]["mask"]))
        np.testing.assert_array_equal(w.grad.numpy(), gs[name] * mask,
                                      err_msg=name)
        np.testing.assert_array_equal(w.grad.numpy(), np.asarray(want),
                                      err_msg=name)


def test_grouped_int8_mask_and_by_value_scalars_equal_per_layer():
    rng = np.random.default_rng(5)
    ws, comps = [], []
    for shape, k, msr in (((3, 3, 4, 8), 5, 0), ((40, 24), 32, 2),
                          ((7,), 0, 3)):
        w = _t((rng.normal(size=shape) * 0.2).astype(np.float32))
        c = tqat.identity_comp(shape, device="cpu")
        c["mask"] = _t((rng.uniform(size=shape) > 0.4).astype(np.int8))
        vals = np.linspace(-60, 60, k).round().astype(int).tolist()
        c["codebook"], _ = tqat.make_codebook(vals, device="cpu")
        c["codebook_k"], c["msr_bits"] = k, msr
        ws.append(w)
        comps.append(c)
    for w, c, g in zip(ws, comps, tqat.fake_quant_weights(ws, comps)):
        assert torch.equal(g, tqat.fake_quant_weight(w, c))


@pytest.mark.parametrize("path", ["grouped", "per-layer"])
def test_nan_weight_makes_its_column_nan_as_jax(path):
    """A NaN weight makes its column's scale NaN (the column maximum passes
    a NaN through), so the whole column is NaN, as in the JAX package; the
    other columns stay exact. The CUDA kernels are held to the same on the
    card."""
    rng = np.random.default_rng(9)
    w = (rng.normal(size=(3, 3, 4, 6)) * 0.1).astype(np.float32)
    w[1, 2, 0, 4] = np.nan
    jc = jqat.identity_comp(w.shape)
    mask = np.ones(w.shape, np.float32)
    mask[0, 0, 1, 4] = 0.0
    jc["mask"] = jnp.asarray(mask)
    jc["codebook"], jc["codebook_k"] = jqat.make_codebook(list(range(-8, 9)))
    got = (tqat.fake_quant_weights([_t(w)], [_to_torch(jc)])[0]
           if path == "grouped" else tqat.fake_quant_weight(_t(w),
                                                             _to_torch(jc)))
    want = np.asarray(jqat.fake_quant_weight(jnp.asarray(w), jc))
    assert np.isnan(want[..., 4]).all() and not np.isnan(want[..., :4]).any()
    np.testing.assert_array_equal(got.numpy(), want)   # NaN == NaN here


def _resnet8_step_inputs():
    model = tcnn.resnet8()
    params = init_params(0, model.spec, "cpu")
    state = init_params(0, model.state_spec, "cpu")
    weights = {cl.name: model.get_weight(params, cl.name).numpy()
               for cl in model.comp_layers}
    comp = {n: _to_torch(c) for n, c in _mixed_comps(weights, 6).items()
            if c is not None}
    rng = np.random.default_rng(7)
    x = _t(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    y = _t(rng.integers(0, 10, 4))
    return model, params, state, comp, (x, y)


def _per_layer(monkeypatch):
    """Route every layer through its own fake-quant call (the per-layer
    path: a layer called without ``w_eff`` fake-quantizes its weight alone)
    and count the model-wide grouped calls that remain."""
    calls = []
    monkeypatch.setattr(tcnn, "_fake_quant_all",
                        lambda *a, **k: calls.append(1))
    return calls


def test_resnet8_forward_and_train_step_equal_the_per_layer_path(monkeypatch):
    model, params, state, comp, (x, y) = _resnet8_step_inputs()

    class _Data:
        def batch(self, step, batch_size, split="train", *, device):
            return x, y

    runner = CnnRunner(model, _Data(), batch_size=4, device="cpu",
                       qcfg=QuantConfig.on())
    opt = runner.optimizer.init(params)
    grouped = runner.model.apply(params, state, x, train=False,
                                 qcfg=QuantConfig.on(), comp=comp)[0]
    g_loss, g_grads, _ = runner.loss_and_grads(params, state, comp, (x, y))
    g_params, _, _, _ = runner.train_step(params, state, opt, comp, (x, y))

    calls = _per_layer(monkeypatch)
    per = runner.model.apply(params, state, x, train=False,
                             qcfg=QuantConfig.on(), comp=comp)[0]
    p_loss, p_grads, _ = runner.loss_and_grads(params, state, comp, (x, y))
    p_params, _, _, _ = runner.train_step(params, state, opt, comp, (x, y))
    assert len(calls) == 3                       # the grouped path was off

    assert torch.equal(grouped, per)
    assert torch.equal(g_loss, p_loss)
    for tree_g, tree_p in ((g_grads, p_grads), (g_params, p_params)):
        for a, b in zip(tree_leaves(tree_g), tree_leaves(tree_p)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["lenet5", "resnet8"])
def test_qat_forward_makes_one_grouped_call(arch, monkeypatch):
    """One grouped call a fake-quant forward and no per-layer call; none on
    a float forward; one in serve mode too, for the layers without an
    artifact (here all of them)."""
    model = getattr(tcnn, arch)()
    params = init_params(0, model.spec, "cpu")
    state = init_params(0, model.state_spec, "cpu")
    x = torch.zeros((2, 32, 32, 3))
    grouped, per_layer = [], []
    real_group, real_layer = tqat.fake_quant_weights, tqat.fake_quant_weight
    monkeypatch.setattr(tqat, "fake_quant_weights", lambda *a: (
        grouped.append(1), real_group(*a))[1])
    monkeypatch.setattr(tqat, "fake_quant_weight", lambda *a: (
        per_layer.append(1), real_layer(*a))[1])
    model.apply(params, state, x, qcfg=QuantConfig.on())
    assert (len(grouped), len(per_layer)) == (1, 0)
    model.apply(params, state, x, qcfg=QuantConfig.off())
    assert len(grouped) == 1
    model.apply(params, state, x, qcfg=QuantConfig.serve())
    assert (len(grouped), len(per_layer)) == (2, 0)


def _good_group():
    ws = [torch.zeros((3, 3, 2, 4)), torch.zeros((5, 6))]
    comps = [tqat.identity_comp(tuple(w.shape), device="cpu") for w in ws]
    return ws, comps


@pytest.mark.parametrize("case,match", [
    ("empty", "empty group"),
    ("count", "2 weights but 1 comp"),
    ("shape", r"group entry 1: mask shape"),
    ("dtype", r"group entry 0: w must be float32"),
    ("mask_dtype", r"group entry 1: mask must be float32 or int8"),
    ("devices", r"group entry 1: w is on meta"),
    ("strided", r"group entry 1: w must be contiguous"),
    ("no_elements", r"group entry 0: w must have an output axis"),
    ("k", r"group entry 1: k=33"),
    ("codebook", r"group entry 0: codebook shape"),
])
def test_group_checks_raise_naming_the_entry(case, match):
    ws, comps = _good_group()
    ops.fake_quant_group(ws, comps)
    if case == "empty":
        ws, comps = [], []
    elif case == "count":
        comps = comps[:1]
    elif case == "shape":
        comps[1]["mask"] = torch.ones((6, 5))
    elif case == "dtype":
        ws[0] = ws[0].double()
    elif case == "mask_dtype":
        comps[1]["mask"] = comps[1]["mask"].to(torch.int32)
    elif case == "devices":
        ws[1] = torch.zeros((5, 6), device="meta")
    elif case == "strided":
        ws[1] = torch.zeros((6, 5)).T
    elif case == "no_elements":
        ws[0] = torch.zeros((0, 4))
        comps[0] = tqat.identity_comp((0, 4), device="cpu")
    elif case == "k":
        comps[1]["codebook_k"] = 33
    elif case == "codebook":
        comps[0]["codebook"] = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        ops.fake_quant_group(ws, comps)


def test_grouped_kernel_wrapper_refuses_cpu_tensors():
    ws, comps = _good_group()
    before = tkernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.launch_group(ws, comps)
    assert tkernel.launches == before


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.fake_quant.ref", "repro_torch.kernels.fake_quant.ops",
    "repro_torch.kernels.fake_quant.fake_quant", "repro_torch.core.qat"])
def test_each_fake_quant_module_imports_first(module):
    """`qat` imports `ops`, which imports `ref`, which imports `qat`: each
    must import first in a fresh interpreter (importing `ref` first used to
    fail on the partly initialised module)."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run([sys.executable, "-c", f"import {module}"],
                          capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 0, proc.stderr
