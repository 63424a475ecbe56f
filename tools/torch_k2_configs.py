#!/usr/bin/env python
"""Time every configuration of the port's LUT GEMM (K2) on a CUDA card.

At each shape of `SHAPES` (K2's decode, prefill and serve shapes across the
port's models), every legal configuration (`autotune.candidate_blocks`) is
run on seeded weights and float32 X, checked bit-equal to the untuned
configuration (`lut_matmul.default_config`), and timed as device time in a
CUDA graph (the median replay of 20 calls, over 5 replays). Beside each
time stands the tuner model's estimate (`autotune.roofline_time`) and, per
shape, the configuration the model picks (what a call without one takes).

    python3 tools/torch_k2_configs.py [OUT.json]

Prints one line a shape and writes the table (default
``chiprun_out/k2_configs.json``): a list of {M, K, N, default, model_pick,
plain_err, configs: {config: [bit_equal, device_ms, model_ms]}}. Exits
non-zero if a configuration is not bit-equal to the untuned one. Needs a
CUDA card and ``nvcc`` (the kernel builds from this checkout).
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (M, K, N): decode steps (M = 4, 8, 32, 40: olmo-1b, mamba2, whisper,
# internvl2, recurrentgemma, phi3.5-moe's experts), prefills (M = 160 to
# 6,000) and ResNet-20's serve pass at batch 256 (K rounded up to 8)
SHAPES = [(4, 2048, 2048), (4, 2048, 8192), (4, 8192, 2048), (4, 4096, 2048),
          (4, 1280, 5120), (4, 6144, 16384), (32, 4096, 6400),
          (40, 4096, 6400), (8, 4096, 6400), (4, 2560, 2560), (4, 2560, 256),
          (160, 4096, 6400), (256, 2048, 2048), (1024, 2048, 2048),
          (2048, 6144, 6144), (1024, 2048, 8192), (1024, 8192, 2048),
          (6000, 1280, 1280), (6000, 1280, 5120), (6000, 5120, 1280),
          (256, 64, 10), (16384, 576, 64), (16384, 288, 64), (16384, 32, 64),
          (65536, 288, 32), (65536, 144, 32), (65536, 16, 32),
          (262144, 144, 16), (262144, 32, 16), (37, 200, 64), (5, 136, 32)]
CALLS, REPLAYS = 20, 5


def graph_ms(torch, fn) -> float:
    """Device ms of one ``fn()``: CALLS calls captured in a CUDA graph, the
    median of REPLAYS timed replays."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k2_configs: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.schedule import symmetric_codebook_values
    from repro_torch.kernels.lut_matmul import autotune as at
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.kernels.lut_matmul import ops, ref

    out = Path(argv[1]) if len(argv) > 1 else ROOT / "chiprun_out" / \
        "k2_configs.json"
    print(f"[env] torch {torch.__version__} {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    k2.LIBRARY.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for cfg in (k2.K2Config(bm, bn, dq) for bm, bn in k2.TILES
                for dq in k2.DEQUANT):
        info = k2.config(cfg)
        print(f"[config] {cfg} registers {info['registers']} spill "
              f"{info['spill_bytes']} smem {info['smem_bytes']} blocks/SM "
              f"{info['blocks_per_sm']}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tuner = at.BlockAutotuner()
    rows, unequal = [], []
    for m, k, n in SHAPES:
        kp = -(-k // 128) * 128
        w = torch.randn((kp, n), generator=gen, device="cuda") * 0.05
        packed, cb, scale = ops.compress_layer_weights(
            w, symmetric_codebook_values(16), block_k=128)
        x = torch.randn((m, k), generator=gen, device="cuda")

        def run(cfg):
            return ops.lut_matmul_fused(x, packed, cb, scale, pack_block=128,
                                        config=cfg)

        untuned = k2.default_config(n)
        base = run(untuned)
        plain = ref.lut_matmul_fused_ref(x, packed, cb, scale, block_k=128)
        pick = tuner.best(m, k, kp, n, device=x.device)
        row = dict(M=m, K=k, N=n, default=str(untuned), model_pick=str(pick),
                   plain_err=float((base - plain).abs().max()), configs={})
        for cfg in at.candidate_blocks(m, k, n):
            equal = bool(torch.equal(run(cfg), base))
            if not equal:
                unequal.append((m, k, n, str(cfg)))
            row["configs"][str(cfg)] = [
                equal, graph_ms(torch, lambda: run(cfg)),
                at.roofline_time(m, k, n, cfg) * 1e3]
        times = {c: v[1] for c, v in row["configs"].items()}
        best = min(times, key=times.get)
        print(f"[k2] M={m} K={k} N={n}: default {untuned} "
              f"{times[str(untuned)]:.4f}, model {pick} {times[str(pick)]:.4f}"
              f" ({times[str(pick)] / times[str(untuned)]:.3f} of default), "
              f"fastest {best} {times[best]:.4f} ms; all bit-equal "
              f"{all(v[0] for v in row['configs'].values())}, plain err "
              f"{row['plain_err']:.2e}", flush=True)
        rows.append(row)
        del w, packed, x, base, plain
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    print(f"[k2] {len(rows)} shapes -> {out}", flush=True)
    if unequal:
        print(f"[k2] not bit-equal to the untuned configuration: {unequal}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
