#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py          # from the repository root, one CUDA card

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel of the serve path from the sources in this checkout
   (nvcc, sm_90a) and prints the build time and ptxas resource lines;
3. holds the LUT-GEMM kernel against its plain PyTorch version at every
   (M, K_pad, N, epilogue) the ResNet-20 serve pass launches at batch 256,
   two ResNet-50 shapes, each activation with bias and residual, and a
   bfloat16-x case; times kernel, plain version and one library call
   (torch.matmul on the dequantized weights plus the same epilogue) with CUDA
   events, and computes each case's bound;
4. drives the port's main path: a ResNet-20 at its published width (seeded
   random weights, batch-norm statistics of one synthetic training batch,
   every layer restricted to 16 int8 values, one layer pruned 50%) saved as
   a plan complete through ``schedule``, loaded, and run
   through ``Pipeline.from_plan(..., device="cuda").run()`` — export, then
   serve at batch 256 — with the kernel's launch count read around that run;
5. prints the ``kernels`` JSON line, then the result line.

Any failure raises and the script exits non-zero. It refuses to run without
a CUDA device, and outside a checkout of the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BATCH = 256                 # serve batch of the main path
R50_BATCH = 64              # batch of the two ResNet-50 kernel shapes
REPS = 25                   # timed turns per case (medians reported)
RTOL = ATOL = 1e-4          # kernel vs plain: float32, summation order only
PEAK_FP32_FLOPS = 67e12     # H100 SXM fp32 (non-tensor-core), dense
PEAK_HBM_BYTES = 3.35e12    # H100 SXM HBM3
KERNEL_SOURCE = "src/repro_torch/kernels/lut_matmul/csrc/lut_matmul.cu"
REPLACES = "src/repro/kernels/lut_matmul/lut_matmul.py:125"


def symmetric_codebook_values(k: int) -> list:
    """k int8 values: 0 plus levels spread over the int8 range (a copy of
    the JAX package's test fixture of the same name)."""
    n_neg = k // 2
    n_pos = k - 1 - n_neg
    values = sorted({0} | {-int(v) for v in np.linspace(16, 120, n_neg)}
                    | {int(v) for v in np.linspace(16, 120, n_pos)})
    assert len(values) == k, (k, values)
    return values


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernel phase


def main_path_shapes(comp_layers, batch, pack_block=128):
    """{(M, K_pad, N, has_bias): launches per forward} of a CNN's serve pass
    (one LUT-GEMM launch per compressed layer; dense layers carry a bias)."""
    shapes = {}
    for cl in comp_layers:
        k = cl.c_in * cl.kernel * cl.kernel
        key = (batch * cl.out_hw[0] * cl.out_hw[1],
               -(-k // pack_block) * pack_block, cl.c_out, cl.kind == "dense")
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def make_case(torch, ops, m, k_pad, n, *, seed, bias, residual, x_dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    w = torch.randn((k_pad, n), generator=gen, device=dev) * 0.05
    packed, cb, scale = ops.compress_layer_weights(
        w, symmetric_codebook_values(16), block_k=128)
    x = torch.randn((m, k_pad), generator=gen, device=dev).to(x_dtype)
    return dict(
        x=x, packed=packed, codebook=cb, scale=scale,
        bias=(torch.randn((n,), generator=gen, device=dev) * 0.1
              if bias else None),
        residual=(torch.randn((m, n), generator=gen, device=dev)
                  if residual else None))


def bound(m, k, n, case):
    """Least time on an H100 SXM: each input read once, the output written
    once, against HBM bandwidth; 2*M*K*N fp32 operations against the fp32
    peak. Returns (ms, "bytes" | "operations")."""
    nbytes = (case["x"].numel() * case["x"].element_size()
              + case["packed"].numel() + case["codebook"].numel()
              + 4 * n + 4 * m * n)
    if case["bias"] is not None:
        nbytes += 4 * n
    if case["residual"] is not None:
        nbytes += 4 * m * n
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = 2.0 * m * k * n / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_turns(torch, fns, reps):
    """Median ms of each fn, timed with CUDA events in interleaved turns
    (order reversed every other turn) after one warm-up call each."""
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    names = list(fns)
    for r in range(reps):
        for name in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(v) for name, v in times.items()}


def kernel_phase(torch, ops, ref, cases):
    """cases: [(label, M, K_pad, N, activation, bias?, residual?, x dtype,
    launches per main-path forward)]."""
    rows = []
    for i, (label, m, k, n, act, with_bias, with_res, x_dtype,
            per_fwd) in enumerate(cases):
        c = make_case(torch, ops, m, k, n, seed=1000 + i, bias=with_bias,
                      residual=with_res, x_dtype=x_dtype)
        args = (c["x"], c["packed"], c["codebook"], c["scale"])
        kw = dict(bias=c["bias"], residual=c["residual"], activation=act)
        y_kernel = ops.lut_matmul_fused(*args, **kw, pack_block=128)
        y_plain = ref.lut_matmul_fused_ref(*args, **kw, block_k=128)
        torch.cuda.synchronize()
        if not torch.isfinite(y_kernel).all():
            raise AssertionError(f"{label}: kernel output not finite")
        err = (y_kernel - y_plain).abs()
        max_err = float(err.max())
        if not bool((err <= ATOL + RTOL * y_plain.abs()).all()):
            raise AssertionError(
                f"{label}: kernel disagrees with the plain version, max abs "
                f"err {max_err:.3e} (rtol {RTOL}, atol {ATOL})")

        w_deq = ref.dequantize(c["packed"], c["codebook"], c["scale"], 128)
        act_fn = ref.ACTIVATIONS[act]

        def library():
            y = torch.matmul(c["x"].float(), w_deq)
            if c["bias"] is not None:
                y = y + c["bias"]
            y = act_fn(y)
            return y if c["residual"] is None else y + c["residual"]

        ms = time_turns(torch, {
            "kernel": lambda: ops.lut_matmul_fused(*args, **kw,
                                                   pack_block=128),
            "plain": lambda: ref.lut_matmul_fused_ref(*args, **kw,
                                                      block_k=128),
            "library": library}, REPS)
        b_ms, b_by = bound(m, k, n, c)
        epi = "+".join([act] + ["bias"] * with_bias + ["res"] * with_res)
        row = dict(case=label, M=m, K=k, N=n, epilogue=epi,
                   x_dtype=str(x_dtype).replace("torch.", ""),
                   per_forward=per_fwd, max_abs_err=max_err,
                   ms=ms["kernel"], plain_ms=ms["plain"],
                   library_ms=ms["library"], bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        print(f"[kernel] {label:<20} M={m:<7} K={k:<5} N={n:<4} {epi:<14} "
              f"{row['x_dtype']:<8} err={max_err:.2e} kernel={ms['kernel']:.4f}"
              f" plain={ms['plain']:.4f} library={ms['library']:.4f} "
              f"bound={b_ms:.4f} ms ({b_by})", flush=True)
        del c, y_kernel, y_plain, w_deq
    return rows


# --------------------------------------------------------------- main path


def calibrated_bn_state(torch, model, params, state, x):
    """Batch-norm running statistics of one data batch, as a served model
    carries them (a fresh init's identity statistics let the activations of
    a random-weight net drift with depth). A train-mode forward normalises
    with batch statistics and returns ``0.9 * state + 0.1 * batch``; from a
    zero state that is ``0.1 * batch``."""
    from repro_torch._device import tree_map

    zero = tree_map(torch.zeros_like, state)
    with torch.no_grad():
        _, new = model.apply(params, zero, x, train=True)
    return tree_map(lambda v: v / 0.1, new)


def main_path(torch, plan_dir):
    from repro_torch.core import qat
    from repro_torch.core.export import export_model
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.kernels.lut_matmul import lut_matmul as kernel
    from repro_torch.nn.cnn import resnet20
    from repro_torch.nn.layers import QuantConfig
    from repro_torch.nn.spec import init_params
    from repro_torch.pipeline.config import PipelineConfig, TargetConfig
    from repro_torch.pipeline.pipeline import Pipeline
    from repro_torch.pipeline.plan import CompressionPlan

    model = resnet20()
    cfg = PipelineConfig(target=TargetConfig(kind="cnn", arch="resnet20",
                                             batch_size=BATCH))
    params = init_params(cfg.target.seed, model.spec, "cpu")
    x_cal, _ = SyntheticImages(seed=cfg.target.data_seed).batch(
        0, BATCH, "train", device="cpu")
    state = calibrated_bn_state(
        torch, model, params,
        init_params(cfg.target.seed, model.state_spec, "cpu"), x_cal)
    comp = {}
    for cl in model.comp_layers:
        w = model.get_weight(params, cl.name)
        c = qat.identity_comp(tuple(w.shape), device="cpu")
        c["codebook"], c["codebook_k"] = qat.make_codebook(
            symmetric_codebook_values(16), device="cpu")
        if cl.name == "s2b2/conv1":
            c["mask"] = qat.magnitude_prune_mask(w, 0.5)
        comp[cl.name] = c
    plan = CompressionPlan(
        config=cfg.to_dict(),
        target={"kind": "cnn", "arch": "resnet20", "name": "resnet20"},
        completed=("profile", "energy_model", "schedule"),
        params=params, state=state, comp=comp)
    base = plan_dir / "resnet20_plan"
    plan.save(base)

    loaded = CompressionPlan.load(base)
    kernel.launches = 0
    t0 = time.perf_counter()
    ran = Pipeline.from_plan(loaded, device="cuda").run(verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches

    arts = ran.artifacts
    forwards = 1 + max(cfg.train.eval_batches, 1)
    if len(arts) != 22 or launches != 22 * forwards:
        raise AssertionError(
            f"expected 22 compressed layers and {22 * forwards} kernel "
            f"launches over {forwards} forwards, got {len(arts)} layers and "
            f"{launches} launches")
    rel = ran.metrics["serve_logit_rel_err"]
    if not rel < 2e-2:
        raise AssertionError(f"serve_logit_rel_err {rel} >= 2e-2")

    # the export on the card is the export on the CPU, byte for byte
    cpu_arts = export_model(model, params, comp)
    for name, a in arts.items():
        for f in ("packed", "codebook", "scale"):
            if not torch.equal(getattr(a, f).cpu(), getattr(cpu_arts[name], f)):
                raise AssertionError(f"{name}.{f}: card export != CPU export")

    # served throughput of the compressed forward, after warm-up
    dev_params = ran.params
    x, _ = SyntheticImages(seed=cfg.target.data_seed).batch(
        0, BATCH, "val", device="cuda")
    qserve = QuantConfig.serve()
    n_timed = 10
    with torch.no_grad():
        logits, _ = model.apply(dev_params, ran.state, x, qcfg=qserve,
                                comp=ran.comp, serve=arts)
        torch.cuda.synchronize()
        if tuple(logits.shape) != (BATCH, 10) or not torch.isfinite(
                logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        t0 = time.perf_counter()
        for _ in range(n_timed):
            model.apply(dev_params, ran.state, x, qcfg=qserve, comp=ran.comp,
                        serve=arts)
        torch.cuda.synchronize()
        images_per_s = n_timed * BATCH / (time.perf_counter() - t0)

    metrics = {k: v for k, v in ran.metrics.items()
               if k.startswith(("serve_", "export_", "wall_s_"))}
    metrics.update(serve_images_per_s=images_per_s, main_path_wall_s=wall,
                   kernel_launches=launches, serve_forwards=forwards)
    print("[main] " + json.dumps(metrics, sort_keys=True), flush=True)
    return launches


# --------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(src/repro_torch missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.lut_matmul import lut_matmul as kernel
    from repro_torch.kernels.lut_matmul import ops, ref
    from repro_torch.nn.cnn import resnet20, resnet50

    torch.set_float32_matmul_precision("highest")   # no TF32 in the library call
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    lib = kernel.build()
    print(f"[build] {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in kernel.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}", flush=True)

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(f"resnet20 x{cnt}", m, k, n, "none", b, False, f32, cnt)
             for (m, k, n, b), cnt in sorted(
                 main_path_shapes(resnet20().comp_layers, BATCH).items(),
                 reverse=True)]
    r50 = {cl.name: cl for cl in resnet50().comp_layers}
    for name in ("s4b1/conv2", "s1b1/conv2"):
        (m, k, n, b), = main_path_shapes([r50[name]], R50_BATCH)
        cases.append((f"resnet50 {name}", m, k, n, "none", b, False, f32, 0))
    for act in ("none", "relu", "gelu", "silu"):
        cases.append((f"epilogue {act}", 16384, 640, 64, act, True, True,
                      f32, 0))
    cases.append(("bf16 x", 262144, 256, 16, "none", False, False, bf16, 0))
    rows = kernel_phase(torch, ops, ref, cases)

    plan_dir = ROOT / "build" / "chip_smoke"
    launches = main_path(torch, plan_dir)

    path_rows = [r for r in rows if r["per_forward"]]
    total = {key: sum(r[key] * r["per_forward"] for r in path_rows)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_bytes = sum(r["bound_ms"] * r["per_forward"] for r in path_rows
                   if r["bound_by"] == "bytes")
    entry = {
        "name": "lut_matmul", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **total,
        "bound_by": "bytes" if by_bytes >= total["bound_ms"] / 2
        else "operations",
        "scope": f"sum over one ResNet-20 serve forward at batch {BATCH} "
                 "(per-shape times x launches per forward)",
        "shapes": rows,
    }
    print(f"[card] {card}", flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
