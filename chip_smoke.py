#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py          # from the repository root, one CUDA card

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel of the port from the sources in this checkout (one
   nvcc per source, all started together, sm_90a) and prints each build
   time and the ptxas resource lines; K2's build, the longest, runs on
   while the phases that launch no K2 run, which come first: K1's and
   K3's (4 and 7), ``[cosim]``, the train step (8), ``[fault]`` and
   ``[mesh2d]`` (22); ``[time]`` lines give the seconds since the start
   at the end of each group of phases;
3. K2, the LUT GEMM: prints each of its configurations (MMA shape, ring
   stages, tiles, registers, shared memory, blocks per SM:
   ``[k2-design]``); every call without a configuration takes the one the
   process-wide tuner's model resolves; holds the kernel against its
   plain PyTorch version at
   every (M, K, N, epilogue) the ResNet-20 serve pass launches at batch 256,
   both with X padded to K_pad (the pack block) and with the serve path's
   unpadded rows (K rounded up to 8), at two ResNet-50 shapes, at each
   activation with bias and residual, and with bfloat16 x; prints the
   outputs that are not bit-equal to the plain version and the achieved
   GB/s; times kernel, plain version and one library call (torch.matmul on
   the dequantized weights plus the same epilogue) a call at a time between
   CUDA events, kernel and library call also as device time in a CUDA graph
   of back-to-back calls, and computes each case's bound;
4. K1, the transition statistics: holds the kernel against its plain
   version, bin for bin, at the profile path's shapes (16 tiles x T = 64),
   all 12,288 tiles of a ResNet-20 stage-1 conv at batch 256, a batch with
   masked tiles, boundary tiles (extreme psums of both signs, all-zero
   psums) and one tile (K1b); prints each launch's plan (blocks, slabs of
   transitions, shared memory, registers, blocks per SM);
   times kernel and plain version with CUDA events and computes each case's
   bound (no PyTorch call computes these statistics, so there is no library
   time);
5. the serve path: a ResNet-20 at its published width (seeded random
   weights, batch-norm statistics of one synthetic training batch, every
   layer restricted to 16 int8 values, one layer pruned 50%) saved as a plan
   complete through ``schedule``, loaded, and run through
   ``Pipeline.from_plan(..., device="cuda").run()`` — export, then serve at
   batch 256 — with K2's launch count read around that run; then served
   images/s and a split of one served forward (im2col rows, K2, fake-quant
   activations, batch norm and pooling, other), each part timed alone
   (``[serve-breakdown]``);
6. the profile path: ``Pipeline(cfg, device="cuda").run_until("energy_model")``
   on ResNet-20 at batch 256 (seeded random weights, no QAT steps, 16 tiles
   per layer), with K1's launch count read around that run; the card's
   statistics are then held against the plain version on the CPU for the
   same taps and tile indices; then ``[cosim]``: the same pipeline with
   ``profile.verify_cosim`` (22 K1 launches for the statistics and 22 for
   the check, ``cosim_match``, ``cosim_max_abs_diff`` 0 and ``cosim_tiles``
   over every profiled tile), the same through ``python -m repro_torch
   profile --verify-cosim``'s entry point, and K1 against the bit-accurate
   systolic cosim (`repro_torch.cosim`) bin for bin on K1's cases (the
   profile path's tile counts, all 12,288 tiles of a stage-1 conv,
   masked and boundary tiles, one tile) and on random tiles at T from 2
   to 64, K1's ms beside the cosim's seconds;
7. K3, the weight fake-quant: holds the per-layer kernel against its plain
   version, bit for bit, at every weight shape of ResNet-20's 22
   compressible layers (kh*kw*c_in, c_out) with k in {0, 5, 16, 32}, a 50%
   mask and MSR depths 0 and 3, with an int8 mask, with k and MSR depth
   passed by value, on rounding ties and on the +-127 clip; holds the
   grouped kernel (one launch for a whole QAT forward, scale and
   straight-through value inside) against its plain version on all 22
   layers at each k and depth, an int8 mask with the scalars by value,
   ragged shapes, ties and large magnitudes; times one grouped call on a
   forward's 22 weights (device time in a CUDA graph, host time a call)
   beside its bound and, in the same run, the per-layer path it replaces
   (22 kernel launches alone, and 22 `qat.fake_quant_weight` chains); then
   the grouped kernel with a candidate axis (the batched schedule sweep's
   forwards) at 1, 6 and 63 candidates of the 22 weights, per-candidate k,
   MSR depths and masks, and with shared (stride-0) fields mixed in, bit
   for bit against its plain version, one launch a call, timed (device time
   in a CUDA graph) beside its bound and beside the n single-candidate
   grouped launches it replaces;
8. the train step: one QAT step of ResNet-20 at batch 32 from the same
   parameters and batch on the card and on the CPU (the plain K3), held at
   loss rel 1e-5 and every gradient leaf rel-L2 1e-4; then warm QAT steps
   at batch 256 (ms per step, K3 launches per step and per eval forward,
   one each) and a split of one step's time (convolutions, fake-quant
   activations, the grouped weight fake-quant, K3 alone, batch norm,
   optimizer) from each part timed alone;
9. the compress path: ``Pipeline(cfg, device="cuda").run()`` on ResNet-20 at
   batch 256, QAT base training, profile, energy model, the layer-wise
   schedule on the two layers of largest energy share, export and serve,
   under the serial walk, with every kernel's launches and the model's
   forwards read per stage (K3: one launch a fake-quant forward, and one a
   serve-mode forward that leaves a layer unserved);
10. the batched sweep: ResNet-20 at batch 256 through ``energy_model``, then
   its schedule stage (prune 0.7/0.5/0.3 x k 16/24, six candidates a layer,
   two layers) under the serial walk and under the batched sweep from the
   same plan: decisions, masks and codebooks equal, K3 one launch a
   forward (a candidate axis's included), each mode's schedule wall time
   and trials/s (a trial: one (layer, candidate) fine-tune with its weight
   selection and accept check);
11. the compress path again under the default search mode (the batched
   sweep), as users run it: the main path whose launches the ``kernels``
   line reports;
12. ``[lm]``: olmo-1b at its published width and depth (1.177e9
   parameters, seeded init): ``Pipeline(cfg, device="cuda")
   .run_until("export")`` (no LM QAT, every matmul restricted to 4
   values), with launches per stage, 112 exported matmuls and
   `lut_parity_report` over all of them (max < 1e-5); K2 at the LM's
   shapes (M = 1024 prefill and M = 4 decode for 2048 x 2048, 2048 x 8192
   with and without the SiLU epilogue, 8192 x 2048; float32 and bfloat16
   x at each shape) against its plain version, timed as in 3; K3's one
   launch of 7 stacked units x 16 layers (the layer axis as candidates)
   bit for bit against its plain version, timed beside its bound; the
   stacked serve artifacts; 4 seeded prompts of 256 tokens prefilled to
   512 and 8 greedy decode steps, served (K2: 112 launches a prefill or
   step, no K3; the dtype of each launch's x recorded) against fake-quant
   (one K3 launch a step, no K2), at float32 (prefill logit rel err <
   2e-2) and at the config's bfloat16 (reported), with tokens/s and ms a
   step; at float32 a witness: the fake-quant forward with each weight set
   to its artifact's dequantized weight, held to the served logits (rel
   err < 1e-5); and where a served prefill's and decode step's time goes
   (``[lm-breakdown]``: K2's recorded calls of the step replayed through
   the kernel, its plain version and `torch.matmul`, beside their bound);
13. ``[lm-engine]``: the serving engine on that plan at full width. (a)
   ``Pipeline.from_plan(plan, device="cuda")`` through ``serve`` (8
   requests of up to 64 prompt and 16 new tokens, the fake-quant engine
   then the oneshot fallback): engine == oneshot, no build after warmup,
   one K3 launch a forward call and no K2; (b) the packed-LUT engine
   (``lut_serve=True``, float32, 16 requests of 256/249/242 prompt and
   32/29 new tokens, each prompt prefilled in two 128-token chunks) in the
   engine, wave and oneshot modes: greedy tokens equal across the modes,
   no build after warmup, 7 K2 launches a layer a forward call and no K3
   (on the first 4 of the 16 layers), with
   tokens/s, TTFT and latency p50/p99, slot utilization and peak memory,
   and a split of one group decode step and one 4-row chunk step
   (``[lm-engine-breakdown]``); then the engine's row sums (float64,
   rounded once) against a fixed float32 order and PyTorch's float32
   order: engine-mode tokens/s, step ms, and whether a batched step's rows
   equal the rows run alone, gated for the shipped float64 sums
   (``[lm-engine-sums]``); (c) (a)'s trace through a LUT engine: the share
   of greedy tokens equal to (a)'s (reported);
14. ``[lm-fleet]``: the fleet router on that plan's parameters at full
   width and 2 of its 16 layers (the whole model's fleet took 202.3 s,
   PR 21), three resident plans (base, k8, k4; 8 slots, the JAX fleet
   tests' router: watermarks 0.5 / 0.25, hysteresis 2), a burst of 16
   requests of 64 prompt and 16 new tokens from two tenants, then a
   trickle of 6, each drained before the next: the burst degrades to the
   last level without flapping, the trickle recovers to level 0, the
   per-plan and per-tenant accounting sums to the totals, no build after
   warmup, one K3 launch a compressed engine's forward call; each plan's
   routed tokens equal an engine pinned to that plan (engine mode); the
   same drain on ``lut_serve=True`` engines (7 K2 launches a layer a
   compressed forward, K2 launches per plan); then ``serve --plan-in <the
   whole [lm] plan> --plans k4 base`` through the CLI (every request
   served, no build after warmup);
15. ``[lm-train]``: ``repro_torch.launch.train.main`` at olmo-1b's full
   width (8 QAT steps at batch 8 x 64 tokens, the plan saved): step ms,
   peak memory, the losses (finite, the last below the first), one K3
   launch a forward call; the correctly rounded products' backward summed
   in float32 and in float64 and autograd through the float64 product,
   step ms and peak memory each at batch 8 and 64; ``compress --target lm
   --arch olmo-1b --steps 2`` through the CLI (the default path at the
   pipeline's batch of 64 x 64 tokens); the trained params checkpointed
   and restored through ``--ckpt-dir``, bit for bit;
16. ``[lm-train-parity]``: one train step of the reduced olmo-1b (QAT, k
   = 8) on the card and on the CPU: the CPU step on the card's int8
   activation rounding held to the card's at loss rel 1e-5 and gradient
   rel-L2 1e-4, the CPU's own step (its own rounding, with the flips
   counted) at loss rel 1e-5; remat == no remat bit for bit on the card;
   the flash backward against autograd through ``blocked_attention``;
17. ``[lm-recurrent]``: (a) mamba2-1.3b (1.344e9 parameters, 48 SSD
   layers) and (b) recurrentgemma-2b (2.895e9, 8 x (rglru, rglru, local)
   and a tail of 2 rglru blocks) at their published widths and depths,
   seeded: each through export (k = 4; 96 and 200 matmuls, LUT parity
   over each); K2 at the families' new shapes (2048 x 8512 and 4096 x
   2048; 2560 x 2560, 2560 x 256, 2560 x 7680 with gelu, 7680 x 2560) at
   M = 1024 and 4, float32 and bfloat16 X, timed as in 12; K3's grouped
   launches (2 units x 48 layers; 23 units x 8 layers, then the tail's
   16) bit for bit against the plain version; the stacked serve
   artifacts; served (96 / 200 K2 launches a forward) against fake-quant
   (1 / 2 K3 launches a forward) prefill of 4 x 256 tokens and 8 decode
   steps at float32 (logits within 2e-2, and the artifact witness) and
   bfloat16 (reported), with tokens/s and ms a step, and where a served
   step's time goes (``[lm-recurrent-breakdown]``); prefill then decode
   against the full forward (max abs < 1e-3, the JAX package's
   contract); (c) the pipeline's serve stage on (a)'s plan (the
   fake-quant engine with its single-chunk prefill, then the oneshot
   fallback: tokens equal, no build after warmup, one K3 launch a forward
   call, tokens/s, TTFT, peak memory); (d) ``compress --config <json>
   --target lm --arch mamba2-1.3b --steps 2`` through the CLI, the QAT
   batch 8 x 64 tokens (finite losses, one K3 launch a forward, step ms,
   peak memory);
18. ``[lm-scan]``: ``Pipeline(cfg, device="cuda")`` of the routed scan
   target on mamba2-1.3b at its published width and depth, from
   [lm-recurrent]'s seeded parameters: the calibration prefills on the
   card, each of the 48 layers' k from the ladder 4 / 8 / 16 by its
   activity rank over the k = 4 floor, export (96 matmuls, LUT parity),
   96 routed entries with k monotone in the activity share and the
   energy after below the energy before; served (96 K2 launches a
   forward) against fake-quant (one K3) prefill of 4 x 256 tokens and 8
   decode steps at float32, the fake-quant forward and the witness both
   held to the served logits on the served run's int8 activation codes
   (< 1e-5), the logits on each run's own codes reported with the codes
   that flip; then the same pipeline's serve stage (one K3 launch a
   forward call, no build after warmup);
19. ``[lm-moe]``: the routed MoE target on phi3.5-moe-42b-a6.6b at its
   published width (16 experts, top-2) and 2 of its 32 layers, seeded
   on the host: calibration, each expert's k by its traffic rank within
   its layer, export (104 matmuls: 4 attention and 16 x 3 expert matmuls
   a layer, LUT parity), 96 routed entries monotone, energy falls; K2 at
   the expert shapes (4096 x 6400 and 6400 x 4096 at M = 160, a prefill's
   4 x capacity 40, and M = 32, a decode step's 4 x 8) against its plain
   version, its bound and `torch.matmul`; K3's one launch of a fake-quant
   forward (attention units with 2 layers as candidates, expert units
   with 2 x 16) bit for bit against its plain version; served (104 K2
   launches a forward) against fake-quant prefill and decode at float32
   (< 2e-2; on the served codes < 1e-5), each MoE call's dropped fraction;
   the serve stage's engine (4 requests of 256 + 8 tokens: tokens/s,
   TTFT, one K3 launch a forward call, engine vs oneshot token agreement
   reported); card against CPU routing at depth 1 (kept-dispatch counts,
   top-k choices differing counted);
20. ``[lm-vlm]``: internvl2-26b at its published width and 8 of its 48
   layers, seeded: export (56 matmuls, LUT parity), K2 at its shapes
   (6144 x 6144, 6144 x 1024, 6144 x 16384 with the SiLU, 16384 x 6144)
   at M = 2048 and 4 against its plain version, its bound and
   `torch.matmul`; K3's one launch (7 entries x 8 layers) bit for bit;
   served (56 K2 launches a forward) against fake-quant (one K3) prefill
   of 4 x (256 stub patch embeddings + 256 tokens) and 8 decode steps at
   float32 (< 2e-2 on each run's codes; the fake-quant forward and the
   witness on the served codes < 1e-5); prefill + decode against the
   full forward (max abs < 1e-3) and the prefix's effect on the token
   logits; one QAT step with ``prefix_embeds`` at 2 layers (finite loss,
   ms, peak memory);
21. ``[mesh]``, the 1-D device meshes of one process, every shard on
   cuda:0, each part run beside the phase whose models it reuses: after
   6, the profile stage with ``profile_mesh`` over 1 and 4 shards (22 and
   88 K1 launches) and at 15 tiles a layer over 3 and 4 shards (padded
   with masked tiles), every statistic equal to the unsharded stage's bin
   for bin, and the 12,288 tiles of a stage-1 conv over 4 shards against
   one K1 call, both timed; in 10, the batched schedule with a 4-shard
   ``sweep_mesh`` (6 candidates padded to 8): decisions, ``comp_sha256``
   and params equal to the unsharded sweep's, trials/s; in 13 (b), the
   LUT engine in wave mode on a 2-shard request mesh: tokens and every
   float32 logits array equal to the unsharded wave's, twice the forward
   calls and K2 launches a step, tokens/s; in 14, the LUT fleet with wave
   engines without and with that mesh: route log and tokens equal, twice
   the serving K2 launches; a ``[mesh]`` summary line at the end;
   ``[fault]`` (after 8): `run_resilient_loop` over 25 ResNet-20 QAT
   steps at batch 256 (K3 at every step, a checkpoint every 5), twice
   without faults and once with faults at steps 3, 13 and 22: 3 failures,
   3 restores, final step 25, the faulty run's final state bit-equal to
   the fault-free run's (or within the two fault-free runs' gap, printed,
   if the card's step is not deterministic), a `StragglerMonitor`'s
   flags; then 10 steps of AdamW wrapped in the int8 gradient compressor
   (finite losses, ``wire_bytes / raw_bytes``) and one step's gradients'
   int8 codes on the card equal to the CPU's;
22. ``[mesh2d]`` (after ``[fault]``), the 2-D ("data", "model") meshes of
   processes, olmo-1b at full width computing in float32: (a) one
   process over NCCL, a 1 x 1 process mesh on cuda:0, full depth: two
   QAT train steps at 8 x 64 tokens with ``mesh=`` and ``rules=``
   bit-equal to the same steps without a mesh (losses, every leaf of the
   final state), one K3 launch a step; the meshed prefill and serve
   step's logits (and cache) equal to the unmeshed ones; meanwhile four
   processes ask NCCL for an all-reduce with four ranks on cuda:0
   (``[mesh2d] nccl``); (b) four processes on cuda:0 (gloo, CUDA tensors
   through the host, unless that all-reduce worked), a 2 x 2 mesh, 2 of
   the 16 layers (FSDP a layer: each rank keeps its slices and gathers one
   block at a time where the model runs it, K3's one launch on its
   slices; tensor-parallel compute over "model": attention's heads, the
   FFN's width and the vocabulary split, each rank keeping its model
   chunk): the same two steps against the unmeshed steps at that depth
   (on rank 0), at lr
   1e-5: loss rel 1e-5, gradient (the first Adam moment after step 1)
   rel-L2 1e-4, params abs 2e-4; at the LM target's lr 6e-4 the same gaps
   reported; at both, the int8 activation codes of the first step equal,
   the data ranks' rows and the model ranks' feature chunks put together
   (the second step's flips counted); each rank's K3 launches a step, ms
   a step, peak memory and its peak of gathered bytes alive at once,
   gated at the dry run's bound (the embedding's and one block's chunks:
   parameters, fake-quantized copy and gradient) and below the
   storage-only layout's 413,138,944 bytes; a rank's matmul FLOPs
   (`FlopCounterMode`) gated at 1/4 of the unmeshed step's, beside the dry
   run's; its collectives by kind beside the dry run's; the width of its
   block of a meshed prefill's logits (half the vocabulary); then
   ``[mesh2d] dry`` lines: the dry run's ``gathered_peak_bytes``,
   ``flops`` and ``collectives`` of olmo-1b, qwen2.5-14b and phi3.5-moe
   ``train_4k`` on 32 x 8, and phi3.5-moe's with ``--moe-local``; (c)
   four processes on cuda:0, a 1 x 4 mesh, phi3.5-moe at full width
   (16 experts top-2, expert d_ff 6,400) and 1 of its 32 layers in
   float32, expert parallel (each rank runs 4 experts on the dispatch
   buffer; their outputs all-gathered), with ``moe_local_dispatch``: two
   QAT steps of 8 x 64 tokens against the unmeshed steps on rank 0, at lr
   1e-5: loss rel 1e-5, gradient rel-L2 1e-4, params abs 2e-4, the first
   step's activation codes equal (the model ranks' experts put together),
   one K3 launch a step a rank, a rank's matmul FLOPs equal to the dry
   run's and 1/4 of the unmeshed step's in the experts, attention and
   read-out (the router whole on each rank), its collectives by kind
   equal to the dry run's, its gathered bytes alive at once within the
   dry run's bound; ms a step and peak GB a rank printed; (d) in (c)'s
   four processes after it, on the same 1 x 4 mesh, at full width in
   float32: mamba2-1.3b (2 of 48 layers; its SSM by heads, 16 of 64 a
   rank), recurrentgemma-2b (one (rglru, rglru, local) repeat, 3 of 26
   layers; the RG-LRU's 2,560 channels and the FFN split, the 10 heads
   whole) and whisper-large-v3 (1 encoder and 1 decoder layer over 1,500
   stub frames; the encoder's and the decoder's heads, 5 of 20 a rank,
   cross-attention's too), each two QAT steps of 8 x 64 tokens against
   the unmeshed steps on rank 0 at lr 1e-5 with (c)'s gates (the dry run
   of each cell on 1 x 4 and 1 x 1: a rank's FLOPs and collectives equal,
   the unmeshed step's FLOPs equal the 1 x 1 count), then one meshed
   prefill of 4 x 64 tokens (whisper: its frames too) and one serve step
   from the unmeshed prefill's cache, held on ``cache_shardings``, in
   float32 as run: logits within 1e-5 of the unmeshed forward's and
   decode step's, or that share of the logits' max abs where it passes 1
   (`mesh2d_logit_bound`), the same steps with TF32 products reported
   beside them (``[mesh2d] (d) <arch>`` lines); the ``[mesh2d] dry``
   lines add the three archs' ``train_4k``; (c) and (d) share one
   ``[time]`` line;
23. ``[k2-tune]`` (after 3): K2's configuration tuner on the card's
   balance, measuring the model's top 3 and the untuned configuration at
   olmo-1b's seven units at M = 4 and at its prefill's M = 4 x 256, one
   M = 4 shape each of mamba2, whisper and internvl2, phi3.5-moe's expert
   at M = 32 and ResNet-20's serve shapes at batch 256: tuned == untuned
   bit for bit, tuned against the plain version within 1e-4, untuned /
   tuned / torch.matmul device ms beside the bound, and the main path's
   configuration (the default tuner's model, unmeasured) with its ms, no
   slower than the untuned one within 3%; the saved cache loaded into
   another tuner resolves every shape with 0 retunes; olmo-1b's decode
   step's 112 K2 calls untuned against tuned, and the host ms to issue
   them resolving each configuration against given it;
24. prints the ``kernels`` JSON line (K2's with the configurations it
   launched and ``tune``), then the result line.

Any failure raises and the script exits non-zero. It refuses to run without
a CUDA device, and outside a checkout of the repository.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BATCH = 256                 # serve batch of the main path
R50_BATCH = 64              # batch of the two ResNet-50 kernel shapes
REPS = 25                   # timed turns per case (medians reported)
# K2 vs plain: both sum float64 products and round once to float32, so they
# differ only where float64 summation order moves a sum across a float32
# rounding midpoint (and by the card's tanhf/expf in the gelu/silu epilogue)
RTOL = ATOL = 1e-4
PEAK_FP32_FLOPS = 67e12     # H100 SXM fp32 (non-tensor-core), dense
PEAK_HBM_BYTES = 3.35e12    # H100 SXM HBM3
# H100 SXM population count / count leading zeros: 16 per clock per SM
# (a quarter of the 64 integer ALU lanes), 132 SMs at the 1.98 GHz boost
PEAK_POPC = 16 * 132 * 1.98e9
POPC_PER_TRANSITION = 5     # see k1_bound
PROFILE_TILES = 16          # profile.max_tiles of the profile path
TRAIN_CHECK_BATCH = 32      # card vs CPU train-step check
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
GRAPH_LAUNCHES = 20         # K3 launches per timed CUDA graph replay
K2_TUNE_REPS = 10           # graph replays timing a configuration ([k2-tune])
K2_TUNE_TOP = 3             # configurations [k2-tune] times: the model's best
K2_TUNE_STEP_REPS = 10      # timed turns of the 112-call decode step
K2_PICK_SLACK = 0.03        # timer spread a main-path pick may show
HOST_CALLS = 200            # K3 wrapper calls timed on the host clock
# candidate axes of the K3 candidate phase: one; the sweep phase's 6
# candidates; the largest gathered evaluation of the default schedule (9
# candidates, chunks of at most 64 requests: 63)
K3_CANDIDATES = (1, 6, 63)
# the [lm] phase: olmo-1b at its published width and depth, seeded init
LM_ARCH, LM_CDTYPE = "olmo-1b", "bfloat16"
LM_COMPRESS_K = 4
LM_PROMPTS, LM_PROMPT_LEN, LM_MAX_LEN = 4, 256, 512
LM_DECODE_STEPS = 8
LM_PROMPT_SEED = 100
LM_PARITY = 1e-5            # lut_parity_report, max over every unit
# served vs the fake-quant forward on the artifacts' dequantized weights:
# the same float64-summed products rounded once, so float32 ulps at most
WITNESS_PARITY = 1e-5
SERVE_PARITY = 2e-2         # the README's serve_forward_parity gate
# the [lm-engine] phase: (a) the pipeline's serve stage on the [lm] plan,
# (b) the packed-LUT engine built directly, its trace served in each mode
LM_STAGE_SERVE = dict(compress_k=LM_COMPRESS_K, requests=8, prompt_len=64,
                      new_tokens=16, mixed=True, max_batch=4,
                      verify_oneshot=True)
LM_LUT_REQUESTS, LM_LUT_PROMPT_LEN, LM_LUT_NEW_TOKENS = 16, 256, 32
LM_LUT_PROMPT_SEED = 200
# (b) runs the [lm] model's first LM_ENGINE_LAYERS layers: its gates are
# per row and per forward call (modes equal, builds, launches a call), and
# at 16 layers it took 120-170 s of the script on an H100
LM_ENGINE_LAYERS = 4
LM_LUT_ENGINE = dict(max_batch=8, prompt_buckets=(128, 256),
                     new_token_buckets=(32,), max_waves=2, q_block=128,
                     kv_block=128, cache_dtype="float32", lut_serve=True)
# the [lm-fleet] phase: base / k8 / k4 over the [lm] parameters, the JAX
# fleet tests' router (tests/test_fleet.py), 8 slots; a burst of 16 requests
# (two tenants), then a trickle of 6, each drained before the next
LM_FLEET_ENGINE = dict(max_batch=4, max_waves=2)
LM_FLEET_ROUTER = dict(high_watermark=0.5, low_watermark=0.25, hysteresis=2)
LM_FLEET_K = (8, 4)
LM_FLEET_BURST, LM_FLEET_TRICKLE = 16, 6
LM_FLEET_PROMPT_LEN, LM_FLEET_NEW_TOKENS = 64, 16
LM_FLEET_PROMPT_SEED = 300
# the fleet's engines run the [lm] model's first LM_FLEET_LAYERS layers (its
# gates are structural: levels, accounting, routed == pinned; the 16-layer
# fleet took 202.3 s of the script, PR 21); its CLI stage serves the whole
# [lm] plan
LM_FLEET_LAYERS = 2
# the [lm-train] phase: launch.train's QAT steps at full width, then the
# pipeline's default compress path for LM_COMPRESS_STEPS QAT steps
LM_TRAIN_STEPS, LM_TRAIN_BATCH = 8, 8
LM_COMPRESS_STEPS = 2
LM_COMPRESS_BATCH = 64      # the pipeline's default target.batch_size
LM_BACKWARD_STEPS = 3       # steps of each exact_matmul backward variant
# flash against autograd through blocked_attention on the card: the same
# forward operations; the backward recomputes the probabilities
FLASH_FWD_ATOL, FLASH_GRAD_RTOL = 1e-6, 1e-5
# the [lm-recurrent] phase: mamba2-1.3b and recurrentgemma-2b at their
# published widths and depths, seeded init, every matmul restricted to
# LM_COMPRESS_K values; the engine serves mamba2's plan, and mamba2 trains
# through the CLI at LM_RECURRENT_TRAIN_BATCH sequences a step
LM_RECURRENT = ("mamba2-1.3b", "recurrentgemma-2b")
LM_RECURRENT_UNITS = {"mamba2-1.3b": 96, "recurrentgemma-2b": 200}
LM_RECURRENT_K2_REPS = 10
LM_RECURRENT_TRAIN_BATCH = 8
# prefill then decode against the full forward, float32, no QAT: the JAX
# package's own contract (tests/test_lm.py)
ROUNDTRIP_ATOL = 1e-3
# the [table1] phase: the paper's Table 1 rows for ResNet-20, the protocol
# of benchmarks/table1_energy_savings.py at benchmarks/common.py's default
# budget (`trained`: batch 64, lr 2e-3, 250 QAT steps, accuracy over 4
# batches, profile n_batches=1, max_tiles=8)
T1_BATCH, T1_LR, T1_QAT_STEPS, T1_DATA_SEED = 64, 2e-3, 250, 12
T1_PP = dict(k=32, prune_ratio=0.5, finetune_steps=40, eval_batches=2)
T1_SCHEDULE = dict(prune_ratios=(0.7, 0.5), k_targets=(16,), delta_acc=0.05,
                   finetune_steps=20, trial_finetune_steps=12,
                   eval_batches=2, max_layers=4, min_energy_share=0.0)
T1_SELECTION = dict(k_init=24, k_target=16, delta_acc=0.05, score_batches=1,
                    accept_batches=2, max_score_candidates=6)
# the [lm-encdec] phase: whisper-large-v3 at its published width and depth,
# seeded init; requests of ENCDEC_FRAMES stub encoder frames (the 30-second
# window) and ENCDEC_PROMPT_LEN prompt tokens. The roundtrip runs with
# ENCDEC_BLOCK-wide blocks, a divisor of the frame count: with 512 the
# forward's cross-attention also takes the padded keys, decode's not (the
# JAX package's non-causal mask keeps them), and the gap is reported
ENCDEC_ARCH, ENCDEC_UNITS = "whisper-large-v3", 512
ENCDEC_REQUESTS, ENCDEC_FRAMES, ENCDEC_PROMPT_LEN = 4, 1500, 64
ENCDEC_MAX_LEN, ENCDEC_BLOCK = 128, 500
ENCDEC_ROUNDTRIP_ATOL = 1e-4
ENCDEC_TRAIN_STEPS = 2
# the [lm-scan] phase: ScanTarget on mamba2-1.3b at its published width and
# depth, from [lm-recurrent]'s seeded parameters (2 units x 48 layers)
SCAN_ARCH, SCAN_UNITS = "mamba2-1.3b", 96
# the [lm-moe] phase: MoETarget on phi3.5-moe-42b-a6.6b at its published
# width, MOE_LAYERS of its 32 layers (2.86e9 parameters; all 32 are 41.9e9,
# 168 GB in float32), seeded; a layer is 4 attention and 16 x 3 expert
# matmuls; card vs CPU dispatch at MOE_CHECK_LAYERS layers
MOE_ARCH, MOE_LAYERS, MOE_UNITS_A_LAYER = "phi3.5-moe-42b-a6.6b", 2, 52
MOE_CHECK_LAYERS = 1
# the [lm-vlm] phase: internvl2-26b at its published width, VLM_LAYERS of its
# 48 layers (4.259e9 parameters; all 48 are 1.986e10, 79.4 GB in float32),
# seeded; LM_PROMPTS requests of 256 stub patch embeddings and LM_PROMPT_LEN
# prompt tokens, decoded to VLM_MAX_LEN; one QAT step at VLM_TRAIN_LAYERS
# layers (1.919e9 parameters) on 1 x (256 patches, VLM_TRAIN_TOKENS tokens)
VLM_ARCH, VLM_LAYERS, VLM_TRAIN_LAYERS = "internvl2-26b", 8, 2
VLM_MAX_LEN = 256 + LM_PROMPT_LEN + LM_DECODE_STEPS
VLM_TRAIN_TOKENS = 64
# the token positions' logits after the prefix against the tokens alone:
# the prefix must move them by more than this (rel)
VLM_PREFIX_MATTERS = 1e-2
# the [cosim] phase's T sweep: COSIM_TILES random tiles at each T
COSIM_T, COSIM_TILES = (2, 3, 7, 16, 33, 64), 8
# [mesh]: shards of the tile and candidate meshes and of the request mesh,
# every shard on cuda:0 (one card checks the split, padding and reduction)
MESH_SHARDS, MESH_REQUEST_SHARDS = 4, 2
MESH_PAD_TILES = 15         # tiles a layer at which the shards pad
MESH_FLOAT_RTOL = 1e-6      # sharded energy sums, if they are not exact
# [fault]: the resilient loop's steps, checkpoint period and injected faults
FAULT_STEPS, FAULT_EVERY, FAULT_AT = 25, 5, (3, 13, 22)
FAULT_COMPRESS_STEPS = 10
# [mesh2d]: (a) olmo-1b at full depth on a 1 x 1 mesh; (b) 2 of its 16
# layers (four ranks, each holding its slices and gathering a block at a
# time, share one card) on a 2 x 2 mesh of four processes; two QAT steps of
# batch x tokens each; the prefill and serve check's rows x prompt tokens
MESH2D_STEPS, MESH2D_BATCH, MESH2D_TOKENS = 2, 8, 64
MESH2D_LAYERS, MESH2D_SHAPE = 2, (2, 2)
MESH2D_PREFILL = (4, 64)
MESH2D_BLOCK = 128          # the steps' attention blocks (q and kv)
# (b)'s gathered bytes alive at once a rank are gated below what the
# storage-only layout held at the same depth, the whole tied embedding
# (measured on this card: 413,138,944 bytes, PERF.md section 6)
MESH2D_STORAGE_ONLY_GATHERED = 413_138_944
# the cells whose dry run [mesh2d] prints, on the 32 x 8 mesh
MESH2D_DRY_CELLS = ("olmo-1b", "qwen2.5-14b", "phi3.5-moe-42b-a6.6b",
                    "mamba2-1.3b", "recurrentgemma-2b", "whisper-large-v3")
# (c): phi3.5-moe at full width, 1 of its 32 layers, on a 1 x 4 mesh of
# four processes on cuda:0: each model rank runs 4 of the 16 experts and
# gathers no expert (the data axis has one position)
MESH2D_MOE_ARCH, MESH2D_MOE_LAYERS = "phi3.5-moe-42b-a6.6b", 1
MESH2D_MOE_SHAPE = (1, 4)
# (d), in (c)'s ranks after it: the recurrent mixers and whisper's encoder
# and cross-attention split over "model" on the same 1 x 4 mesh, at full
# width and these depths (recurrentgemma one (rglru, rglru, local) repeat;
# whisper one encoder and one decoder layer over its stub frames)
MESH2D_SPLIT = {"mamba2-1.3b": dict(n_layers=2),
                "recurrentgemma-2b": dict(n_layers=3),
                "whisper-large-v3": dict(n_layers=1, n_enc_layers=1)}
MESH2D_ENC_FRAMES = 1500
MESH2D_LOGIT_ATOL = 1e-5    # meshed prefill and serve logits vs unmeshed
# rank 0 runs the unmeshed reference steps while the others wait for it
MESH2D_MOE_TIMEOUT_S = 300
MESH2D_MOE_DEADLINE_S = 780     # (c)'s and (d)'s ranks are killed after this
MESH2D_TIMEOUT_S = 120      # init_process_group(timeout=) of every rank
MESH2D_DEADLINE_S = 300     # (b)'s ranks are killed after this
MESH2D_NCCL_DEADLINE_S = 90
# the steps' learning rate. At the LM target's 6e-4 one AdamW step from the
# random init moves every weight by about lr and more than halves the
# loss; the first Adam moment's rounding-level differences then grow into
# parameter gaps of the order of lr a step later (PERF.md section 6): (b)
# gates at MESH2D_LR and reports MESH2D_LR_TARGET
MESH2D_LR, MESH2D_LR_TARGET = 1e-5, 6e-4
PARAM_ATOL = 2e-4           # LM train parity: params after the steps
K2 = dict(name="lut_matmul",
          source="src/repro_torch/kernels/lut_matmul/csrc/lut_matmul.cu",
          replaces="src/repro/kernels/lut_matmul/lut_matmul.py:125")
K1 = dict(name="transition_energy",
          source="src/repro_torch/kernels/transition_energy/csrc/"
                 "transition_energy.cu",
          replaces="src/repro/kernels/transition_energy/"
                   "transition_energy.py:201")
K1B_REPLACES = "src/repro/kernels/transition_energy/transition_energy.py:142"
K3 = dict(name="fake_quant",
          source="src/repro_torch/kernels/fake_quant/csrc/fake_quant.cu",
          replaces="src/repro/kernels/fake_quant/fake_quant.py:51")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ build


def build_kernels(libraries):
    """Build every kernel library at once (one nvcc each, in parallel) and
    print each build time and its ptxas resource lines."""
    def build(lib):
        t0 = time.perf_counter()
        path = lib.build()
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(len(libraries)) as pool:
        done = list(pool.map(build, libraries))
    for lib, (path, secs) in zip(libraries, done):
        print(f"[build] {path.relative_to(ROOT)} in {secs:.2f} s", flush=True)
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {lib.name}: {line.strip()}", flush=True)


# ------------------------------------------------------------ K2 phase


def main_path_shapes(comp_layers, batch):
    """{(M, K, N, has_bias): launches per forward} of a CNN's serve pass (one
    LUT-GEMM launch per compressed layer; dense layers carry a bias)."""
    shapes = {}
    for cl in comp_layers:
        key = (batch * cl.out_hw[0] * cl.out_hw[1],
               cl.c_in * cl.kernel * cl.kernel, cl.c_out, cl.kind == "dense")
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def k_pad(k, pack_block=128):
    return -(-k // pack_block) * pack_block


def make_case(torch, ops, m, k_x, k_pad, n, *, seed, bias, residual,
              x_dtype):
    """Weights (K_pad, N) packed at pack block 128; x (M, K_x)."""
    from repro_torch.core.schedule import symmetric_codebook_values

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    w = torch.randn((k_pad, n), generator=gen, device=dev) * 0.05
    packed, cb, scale = ops.compress_layer_weights(
        w, symmetric_codebook_values(16), block_k=128)
    x = torch.randn((m, k_x), generator=gen, device=dev).to(x_dtype)
    return dict(
        x=x, packed=packed, codebook=cb, scale=scale,
        bias=(torch.randn((n,), generator=gen, device=dev) * 0.1
              if bias else None),
        residual=(torch.randn((m, n), generator=gen, device=dev)
                  if residual else None))


def k2_bytes(m, n, case):
    """Bytes K2 must move: each input read once, the output written once."""
    nbytes = (case["x"].numel() * case["x"].element_size()
              + case["packed"].numel() + case["codebook"].numel()
              + 4 * n + 4 * m * n)
    if case["bias"] is not None:
        nbytes += 4 * n
    if case["residual"] is not None:
        nbytes += 4 * m * n
    return nbytes


def bound(m, k, n, case):
    """Least time on an H100 SXM: `k2_bytes` against HBM bandwidth; 2*M*K*N
    operations (K = x's width) against 67 TFLOP/s, the fp32 peak and the
    float64 tensor-core peak alike. Returns (ms, "bytes" | "operations")."""
    t_bytes = k2_bytes(m, n, case) / PEAK_HBM_BYTES
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


def k2_cases(torch, r20_model, r50_model):
    """[(label, M, K_x, K_pad, N, activation, bias?, residual?, x dtype,
    launches per main-path forward, on the serve path's unpadded rows?)]:
    every ResNet-20 serve shape with X padded to K_pad (the like-for-like
    yardstick of earlier slices), two ResNet-50 shapes, each epilogue, bf16
    x, then the ResNet-20 serve shapes as the serve path feeds them."""
    from repro_torch.kernels.lut_matmul.lut_matmul import x_width

    f32, bf16 = torch.float32, torch.bfloat16
    r20 = sorted(main_path_shapes(r20_model.comp_layers, BATCH).items(),
                 reverse=True)
    cases = [(f"resnet20 x{cnt}", m, k_pad(k), k_pad(k), n, "none", b, False,
              f32, cnt, False) for (m, k, n, b), cnt in r20]
    r50 = {cl.name: cl for cl in r50_model.comp_layers}
    for name in ("s4b1/conv2", "s1b1/conv2"):
        (m, k, n, b), = main_path_shapes([r50[name]], R50_BATCH)
        cases.append((f"resnet50 {name}", m, k_pad(k), k_pad(k), n, "none",
                      b, False, f32, 0, False))
    for act in ("none", "relu", "gelu", "silu"):
        cases.append((f"epilogue {act}", 16384, 640, 640, 64, act, True, True,
                      f32, 0, False))
    cases.append(("bf16 x", 262144, 256, 256, 16, "none", False, False, bf16,
                  0, False))
    cases += [(f"serve rows x{cnt}", m, x_width(k), k_pad(k), n, "none", b,
               False, f32, cnt, True) for (m, k, n, b), cnt in r20]
    return cases


def k2_phase(torch, ops, ref, cases, reps=REPS):
    """cases: `k2_cases`. Times kernel, plain version and library call a
    call at a time between CUDA events, the card idle before each call
    (``ms``, ``plain_ms``, ``library_ms``: the host's wrapper and launch
    cost counts, as in every earlier K2 row), and kernel and library call
    as device time in a CUDA graph of back-to-back calls (``device_ms``,
    ``library_device_ms``; `graph_ms`, as K3 is timed; ``timing`` names the
    method `graph_ms` used). The timing launches are not counted as the
    main path's."""
    from repro_torch.kernels.lut_matmul import lut_matmul as k2

    rows = []
    for i, (label, m, k, kp, n, act, with_bias, with_res, x_dtype, per_fwd,
            serve_rows) in enumerate(cases):
        c = make_case(torch, ops, m, k, kp, n, seed=1000 + i, bias=with_bias,
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
        not_equal = int((y_kernel != y_plain).sum())
        if not bool((err <= ATOL + RTOL * y_plain.abs()).all()):
            raise AssertionError(
                f"{label}: kernel disagrees with the plain version, max abs "
                f"err {max_err:.3e} (rtol {RTOL}, atol {ATOL})")

        w_deq = ref.weight_rows(
            ref.dequantize(c["packed"], c["codebook"], c["scale"], 128), k)
        act_fn = ref.ACTIVATIONS[act]

        def library():
            y = torch.matmul(c["x"].float(), w_deq)
            if c["bias"] is not None:
                y = y + c["bias"]
            y = act_fn(y)
            return y if c["residual"] is None else y + c["residual"]

        def kernel():
            return ops.lut_matmul_fused(*args, **kw, pack_block=128)

        launched = k2.launches
        ms = time_turns(torch, {
            "kernel": kernel,
            "plain": lambda: ref.lut_matmul_fused_ref(*args, **kw,
                                                      block_k=128),
            "library": library}, reps)
        device_ms, k_method = graph_ms(torch, kernel, reps)
        library_device_ms, l_method = graph_ms(torch, library, reps)
        k2.launches = launched
        b_ms, b_by = bound(m, k, n, c)
        gbps = k2_bytes(m, n, c) / (device_ms * 1e-3) / 1e9
        epi = "+".join([act] + ["bias"] * with_bias + ["res"] * with_res)
        row = dict(case=label, M=m, K_x=k, K_pad=kp, N=n, epilogue=epi,
                   x_dtype=str(x_dtype).replace("torch.", ""),
                   per_forward=per_fwd, serve_rows=serve_rows,
                   max_abs_err=max_err, not_bit_equal=not_equal,
                   ms=ms["kernel"], plain_ms=ms["plain"],
                   library_ms=ms["library"], bound_ms=b_ms, bound_by=b_by,
                   device_ms=device_ms, library_device_ms=library_device_ms,
                   timing=sorted({k_method, l_method}),
                   device_gb_per_s=gbps)
        rows.append(row)
        print(f"[kernel] {label:<20} M={m:<7} K_x={k:<5} K_pad={kp:<5} "
              f"N={n:<4} {epi:<14} {row['x_dtype']:<8} err={max_err:.2e} "
              f"not_equal={not_equal} a call: kernel={ms['kernel']:.4f} "
              f"plain={ms['plain']:.4f} library={ms['library']:.4f} ms; "
              f"device ({'/'.join(row['timing'])}): kernel={device_ms:.4f} "
              f"library={library_device_ms:.4f} ms, {gbps:.0f} GB/s; "
              f"bound={b_ms:.4f} ms ({b_by})", flush=True)
        del c, y_kernel, y_plain, w_deq
    return rows


def k2_tune_shapes(torch):
    """[(label, M, K_x, K_pad, N)] of `k2_tune_phase`: olmo-1b's seven units
    at a decode step's M (LM_PROMPTS) and at its prefill's (LM_PROMPTS x
    LM_PROMPT_LEN), one decode shape each of mamba2,
    whisper and internvl2, phi3.5-moe's expert w_gate at M = 32, and
    ResNet-20's serve shapes at batch BATCH as the serve path feeds them
    (rows K rounded up to 8, weights padded to the pack block)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.lut_matmul.lut_matmul import x_width
    from repro_torch.nn.cnn import resnet20

    acfg = get_config(LM_ARCH)
    d, f = acfg.d_model, acfg.d_ff
    kv = acfg.n_kv_heads * acfg.resolved_head_dim
    m = LM_PROMPTS
    units = (("wq", d, d), ("wk", d, kv), ("wv", d, kv), ("wo", d, d),
             ("w_gate", d, f), ("w_up", d, f), ("w_down", f, d))
    shapes = [(f"{LM_ARCH} {u}", m, k, k, n) for u, k, n in units]
    shapes += [(f"{LM_ARCH} prefill {u}", m * LM_PROMPT_LEN, k, k, n)
               for u, k, n in units]
    whisper, vlm = get_config(ENCDEC_ARCH), get_config(VLM_ARCH)
    dims = get_config(MOE_ARCH).moe_dims()
    shapes += [("mamba2-1.3b out_proj", m, 4096, 4096, 2048),
               (f"{ENCDEC_ARCH} w_up", ENCDEC_REQUESTS, whisper.d_model,
                whisper.d_model, whisper.d_ff),
               (f"{VLM_ARCH} w_gate", m, vlm.d_model, vlm.d_model, vlm.d_ff),
               (f"{MOE_ARCH} expert w_gate", 32, dims.d_model,
                k_pad(dims.d_model), dims.d_ff)]
    for (mm, k, n, _), cnt in sorted(main_path_shapes(
            resnet20().comp_layers, BATCH).items(), reverse=True):
        shapes.append((f"resnet20 x{cnt} M={mm} K={k} N={n}", mm,
                       x_width(k), k_pad(k), n))
    return shapes


def k2_tune_phase(torch, ops, ref, work):
    """[k2-tune]: K2's configuration tuner on the card. At each
    `k2_tune_shapes` shape a fresh `BlockAutotuner` on the card's balance
    times the model's top K2_TUNE_TOP configurations (device time in a CUDA
    graph, `graph_ms`) and keeps the fastest; the tuned output must equal
    the untuned one (`default_config`, the choice from N alone) bit for bit
    and the plain version within RTOL / ATOL. Untuned, tuned and
    torch.matmul device ms beside the bound, and the configuration the main
    path takes (a call without one: the default tuner's model, no
    measurement) with its device ms; where it is not the untuned
    configuration it must be no slower than the untuned one (within
    K2_PICK_SLACK, the timer's spread). The cache is saved, loaded into
    another tuner and every shape resolved again: 0 retunes. Then olmo-1b's
    decode step's 112 K2 calls (16 layers x 7 units, each its own weights)
    untuned against tuned, between CUDA events and in a CUDA graph, and the
    host's cost of resolving a configuration: the host ms to issue the 112
    calls without a configuration against the same calls with the
    configurations they resolve to. Timing launches are not counted as the
    main path's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.lut_matmul import autotune as at
    from repro_torch.kernels.lut_matmul import lut_matmul as k2

    t0 = time.perf_counter()
    launched, configs = k2.launches, k2.configs.copy()
    balance = at.MachineBalance.from_device(0)
    print("[k2-tune] balance " + json.dumps(dataclasses.asdict(balance),
                                            sort_keys=True), flush=True)
    tuner = at.BlockAutotuner(balance)
    dev = torch.device("cuda", 0)
    rows, problems, chosen = [], [], {}
    for i, (label, m, kx, kp, n) in enumerate(k2_tune_shapes(torch)):
        c = make_case(torch, ops, m, kx, kp, n, seed=5000 + i, bias=False,
                      residual=False, x_dtype=torch.float32)
        args = (c["x"], c["packed"], c["codebook"], c["scale"])

        def run(cfg, args=args):
            return ops.lut_matmul_fused(*args, pack_block=128, config=cfg)

        def measure(cfg, run=run):
            return graph_ms(torch, lambda: run(cfg), K2_TUNE_REPS)[0] * 1e-3

        problem = dict(m=m, k_x=kx, k_pad=kp, n=n, pack_block=128,
                       x_dtype=torch.float32, device=dev)
        problems.append(problem)
        tuned = tuner.best(**problem, measure=measure, top_k=K2_TUNE_TOP)
        untuned = k2.default_config(n)
        main = at.get_default_autotuner().best(**problem)
        chosen[label] = (untuned, tuned)
        y_t, y_u = run(tuned), run(untuned)
        y_p = ref.lut_matmul_fused_ref(*args, block_k=128)
        err = (y_t - y_p).abs()
        w_deq = ref.weight_rows(ref.dequantize(c["packed"], c["codebook"],
                                               c["scale"], 128), kx)
        b_ms, b_by = bound(m, kx, n, c)
        entry = tuner.entries()[at.shape_fingerprint(
            m, kx, kp, n, pack_block=128, x_dtype=torch.float32,
            device=at.device_name(dev))]
        row = dict(case=label, M=m, K_x=kx, K_pad=kp, N=n,
                   untuned=str(untuned), tuned=str(tuned),
                   timed={k: v * 1e3 for k, v in entry["measured_s"].items()}
                   if entry["measured_s"] else None,
                   model_ms=entry["model_s"] * 1e3,
                   bit_equal=bool(torch.equal(y_t, y_u)),
                   max_abs_err=float(err.max()),
                   within_tol=bool((err <= ATOL + RTOL * y_p.abs()).all()),
                   untuned_ms=graph_ms(torch, lambda: run(untuned),
                                       K2_TUNE_REPS)[0],
                   tuned_ms=graph_ms(torch, lambda: run(tuned),
                                     K2_TUNE_REPS)[0],
                   main=str(main),
                   library_ms=graph_ms(
                       torch, lambda: torch.matmul(c["x"], w_deq),
                       K2_TUNE_REPS)[0],
                   bound_ms=b_ms, bound_by=b_by)
        row["main_ms"] = row["untuned_ms"] if main == untuned else graph_ms(
            torch, lambda: run(main), K2_TUNE_REPS)[0]
        rows.append(row)
        print(f"[k2-tune] {label:<36} M={m:<6} K_x={kx:<5} N={n:<5} "
              f"{row['untuned']} -> {row['tuned']} (main path "
              f"{row['main']}): untuned={row['untuned_ms']:.4f} tuned="
              f"{row['tuned_ms']:.4f} main={row['main_ms']:.4f} "
              f"torch.matmul={row['library_ms']:.4f} bound={b_ms:.4f} ms "
              f"({b_by}); bit-equal {row['bit_equal']}, err "
              f"{row['max_abs_err']:.2e}", flush=True)
        del c, y_t, y_u, y_p, w_deq
    bad = [r["case"] for r in rows if not (r["bit_equal"] and r["within_tol"])]
    if bad:
        raise AssertionError(f"[k2-tune] tuned != untuned bit for bit, or "
                             f"tuned vs the plain version past tolerance: "
                             f"{bad}")
    slow = [(r["case"], r["main"], r["main_ms"], r["untuned_ms"])
            for r in rows
            if r["main_ms"] > r["untuned_ms"] * (1 + K2_PICK_SLACK)]
    if slow:
        raise AssertionError(f"[k2-tune] the main path's configuration is "
                             f"slower than the untuned one: {slow}")

    path = tuner.save(work / "k2_autotune.json")
    warm = at.BlockAutotuner(balance, path=str(path))
    again = [warm.best(**p) for p in problems]
    warm_stats = warm.stats()
    if warm_stats["retune_events"] or [str(c) for c in again] \
            != [r["tuned"] for r in rows]:
        raise AssertionError(f"[k2-tune] the saved cache resolved with "
                             f"{warm_stats}: {[str(c) for c in again]}")

    # olmo-1b's decode step: 16 layers x its seven units, own weights each
    olmo = [r for r in rows
            if r["case"].startswith(LM_ARCH) and r["M"] == LM_PROMPTS]
    depth = get_config(LM_ARCH).n_layers
    layers = []
    for layer in range(depth):
        for j, r in enumerate(olmo):
            c = make_case(torch, ops, r["M"], r["K_x"], r["K_pad"], r["N"],
                          seed=7000 + 7 * layer + j, bias=False,
                          residual=False, x_dtype=torch.float32)
            layers.append(((c["x"], c["packed"], c["codebook"], c["scale"]),
                           *chosen[r["case"]]))

    def step(which):
        def calls():
            for args, untuned, tuned in layers:
                ops.lut_matmul_fused(*args, pack_block=128,
                                     config=untuned if which == 0 else tuned)
        return calls

    event_ms = time_turns(torch, {"untuned": step(0), "tuned": step(1)},
                          K2_TUNE_STEP_REPS)
    step_rows = {"calls": len(layers), **{f"{k}_ms": v
                                          for k, v in event_ms.items()},
                 "bound_ms": depth * sum(r["bound_ms"] for r in olmo)}
    for which, name in ((0, "untuned"), (1, "tuned")):
        fn = step(which)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(K2_TUNE_STEP_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        step_rows[f"{name}_device_ms"] = statistics.median(times)
        del graph

    # the host's side of a call: issue the 112 calls without waiting (the
    # queue holds them), resolving each configuration or handed it
    def issue(resolve):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for args, _, _, cfg in layers:
            ops.lut_matmul_fused(*args, pack_block=128,
                                 config=None if resolve else cfg)
        t = time.perf_counter() - t
        torch.cuda.synchronize()
        return t * 1e3

    layers = [(args, u, t, at.get_default_autotuner().best(
        m=args[0].shape[0], k_x=args[0].shape[1],
        k_pad=2 * args[1].shape[0], n=args[1].shape[1], pack_block=128,
        x_dtype=args[0].dtype, device=args[0].device))
        for args, u, t in layers]
    host = {"resolved": [], "given": []}
    for rep in range(K2_TUNE_STEP_REPS + 1):
        for resolve in ((True, False) if rep % 2 else (False, True)):
            ms = issue(resolve)
            if rep:       # the first turn warms up
                host["resolved" if resolve else "given"].append(ms)
    step_rows.update({f"host_issue_{k}_ms": statistics.median(v)
                      for k, v in host.items()})
    step_rows["host_resolve_us_a_call"] = 1e3 * (
        step_rows["host_issue_resolved_ms"]
        - step_rows["host_issue_given_ms"]) / len(layers)
    del layers
    k2.launches, k2.configs = launched, configs
    out = dict(shapes=rows, warm_cache=warm_stats, cache=str(
        path.relative_to(ROOT)), decode_step=step_rows,
        phase_s=time.perf_counter() - t0)
    print("[k2-tune] decode step " + json.dumps(step_rows, sort_keys=True)
          + f"; warm cache {json.dumps(warm_stats, sort_keys=True)}; "
          f"{out['phase_s']:.1f} s", flush=True)
    return out


# ------------------------------------------------------------ K1 phase


def k1_bound(w_tiles, a_blocks, mask):
    """Least time on an H100 SXM for K1's work, in ms, and what sets it.

    Bytes: the int32 tiles, blocks and float32 mask read once, the int64
    event, group-pair and activation-pair bins written once, over HBM
    bandwidth. Operations: POPC_PER_TRANSITION population-count / leading-
    zero operations per MAC transition of an unmasked tile (product toggles,
    accumulator toggles, carry length, and the Hamming weight and top bit of
    the new psum's group; the activation toggles are shared by a row of 64
    MACs) at 16 per clock per SM. The kernel's other integer operations
    (multiplies, masks, divisions by constants, atomics) are not counted, so
    this is a lower bound."""
    n_live = int((mask != 0).sum())
    t_len = a_blocks.shape[2]
    nbytes = (w_tiles.numel() * 4 + a_blocks.numel() * 4 + mask.numel() * 4
              + 8 * (256 * 5 + 2500 + 65536))
    transitions = n_live * 64 * 64 * (t_len - 1)
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = transitions * POPC_PER_TRANSITION / PEAK_POPC
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1_boundary_tiles(np_rng, t_len):
    """Tiles whose psums reach +-64*127*128 and change sign from t to t + 1,
    and tiles whose psums are all zero (the _msb22 zero rule)."""
    alt = np.array([127, -128] * t_len)[:t_len]
    alt2 = np.array([-128, 127] * t_len)[:t_len]
    w = np.stack([
        np.where(np_rng.random((64, 64)) < 0.5, 127, -127),   # mixed signs
        np.full((64, 64), 127), np.full((64, 64), -127),      # extremes
        np_rng.integers(-127, 128, (64, 64)),                 # a == 0
        np.zeros((64, 64), np.int64)])                        # w == 0
    a = np.stack([np.broadcast_to(alt, (64, t_len)),
                  np.broadcast_to(alt, (64, t_len)),
                  np.broadcast_to(alt2, (64, t_len)),
                  np.zeros((64, t_len), np.int64),
                  np_rng.integers(-128, 128, (64, t_len))])
    return w.astype(np.int32), a.astype(np.int32)


def k1_cases(torch, comp_layers):
    """[(label, w_tiles, a_blocks, mask, launches on the profile path)]."""
    from repro_torch.core.profiler import gather_layer_tiles
    from repro_torch.core.stats import pad_to_tiles

    gen = torch.Generator(device="cuda").manual_seed(7)
    np_rng = np.random.default_rng(7)

    def rand(shape, relu):
        x = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int32)
        return x.clamp(min=0) if relu else x

    def tiles(n, t_len=64, relu=True):
        return (rand((n, 64, 64), False), rand((n, 64, t_len), relu),
                torch.ones(n, device="cuda"))

    # the profile path's launches: min(16, the layer's tiles) tiles each
    per_n = {}
    for cl in comp_layers:
        d = cl.matmul_dims(BATCH)
        n = min(PROFILE_TILES, d.total_tiles)
        per_n[n] = per_n.get(n, 0) + 1
    cases = [(f"profile path, {n} tiles", *tiles(n), cnt)
             for n, cnt in sorted(per_n.items(), reverse=True)]
    # every tile of a stage-1 conv at batch 256: M=16, K=144, N=262144
    w_mat = rand((16, 144), False)
    x_cols = rand((144, BATCH * 32 * 32), True)
    w_pad, x_pad = pad_to_tiles(w_mat, x_cols)
    n_all = (w_pad.shape[1] // 64) * (x_pad.shape[1] // 64)
    w_t, a_t = gather_layer_tiles(w_pad, x_pad,
                                  torch.arange(n_all, device="cuda"))
    cases.append((f"stage-1 conv, all {n_all} tiles", w_t, a_t,
                  torch.ones(n_all, device="cuda"), 0))
    del w_mat, x_cols, w_pad, x_pad
    w, a, m = tiles(64, relu=False)
    m[::3] = 0
    cases.append(("masked: 64 tiles, 22 with mask 0", w, a, m, 0))
    wb, ab = k1_boundary_tiles(np_rng, 64)
    cases.append(("boundary tiles", torch.from_numpy(wb).cuda(),
                  torch.from_numpy(ab).cuda(), torch.ones(5, device="cuda"),
                  0))
    w, a, m = tiles(1, t_len=64, relu=False)
    cases.append(("K1b: one tile", w, a, m, 0))
    return cases


def k1_plan(k1, n_tiles, t_len):
    """The launch plan K1's wrapper takes for a batch, with the kernel's
    resources at it: slabs, slab_len, blocks a launch, registers, spill
    bytes, resident blocks per SM, shared memory a block."""
    slabs, slab_len = k1.launch_plan(n_tiles, t_len, k1.sm_count(0))
    return dict(slabs=slabs, slab_len=slab_len, blocks=n_tiles * slabs,
                **k1.config(slab_len))


def k1_phase(torch, cases):
    from repro_torch.kernels.transition_energy import ops, ref
    from repro_torch.kernels.transition_energy import transition_energy as k1

    rows = []
    for label, w, a, m, per_stage in cases:
        if label.startswith("K1b"):
            got = ops.tile_transition_stats(w[0], a[0])
        else:
            got = ops.batched_transition_stats(w, a, mask=m)
        counts = k1.launch(w, a, m)
        plain_counts = ref.transition_counts(w, a, m)
        want = ref.finish_stats(*plain_counts)
        torch.cuda.synchronize()
        for name, g, h in zip(("events", "group_hist", "act_hist"), counts,
                              plain_counts):
            if not torch.equal(g, h):
                raise AssertionError(f"K1 {label}: {name} differs from the "
                                     "plain version")
        max_err = 0.0
        for name, g, h in zip(("energy_sum", "count", "group_hist",
                               "act_hist"), got, want):
            max_err = max(max_err, float((g - h).abs().max()))
            if not torch.equal(g, h):
                raise AssertionError(
                    f"K1 {label}: {name} differs from the plain version "
                    f"(max abs err {max_err:.3e}; required: equal)")
        reps = 3 if w.shape[0] > 1024 else REPS
        ms = time_turns(torch, {"kernel": lambda: k1.launch(w, a, m),
                                "plain": lambda: ref.transition_counts(
                                    w, a, m)}, reps)
        launched = k1.launches
        device_ms, timing = graph_ms(torch, lambda: k1.launch(w, a, m), reps)
        host = host_us(torch, lambda: k1.launch(w, a, m), reps)
        k1.launches = launched
        b_ms, b_by = k1_bound(w, a, m)
        plan = k1_plan(k1, int(w.shape[0]), int(a.shape[2]))
        row = dict(case=label, n_tiles=int(w.shape[0]),
                   live_tiles=int((m != 0).sum()), T=int(a.shape[2]),
                   per_stage=per_stage, max_abs_err=max_err,
                   ms=ms["kernel"], plain_ms=ms["plain"], library_ms=None,
                   device_ms=device_ms, timing=timing, host_us=host,
                   bound_ms=b_ms, bound_by=b_by, plan=plan)
        if label.startswith("K1b"):
            row["replaces"] = K1B_REPLACES
        rows.append(row)
        print(f"[k1] {label:<32} n={row['n_tiles']:<6} T={row['T']:<3} "
              f"err={max_err:.1e} kernel={ms['kernel']:.4f} (device "
              f"{device_ms:.4f}, host {host:.1f} us) plain={ms['plain']:.4f} "
              f"bound={b_ms:.4f} ms ({b_by}); "
              f"{plan['blocks']} blocks ({plan['slabs']} slabs of "
              f"{plan['slab_len']}), {plan['smem_bytes']} B shared, "
              f"{plan['registers']} regs, "
              f"{plan['blocks_per_sm']} blocks/SM", flush=True)
    return rows


# --------------------------------------------------------------- serve path


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


def serve_path(torch, plan_dir):
    from repro_torch.core import qat
    from repro_torch.core.export import export_model
    from repro_torch.core.schedule import symmetric_codebook_values
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

        parts = serve_breakdown(torch, lambda: model.apply(
            dev_params, ran.state, x, qcfg=qserve, comp=ran.comp,
            serve=arts))

    metrics = {k: v for k, v in ran.metrics.items()
               if k.startswith(("serve_", "export_", "wall_s_"))}
    metrics.update(serve_images_per_s=images_per_s, main_path_wall_s=wall,
                   kernel_launches=launches, serve_forwards=forwards)
    print("[serve] " + json.dumps(metrics, sort_keys=True), flush=True)
    print("[serve-breakdown] " + json.dumps(parts, sort_keys=True),
          flush=True)
    return launches


def serve_breakdown(torch, forward):
    """ms of one served forward and of its parts, each part's calls (as the
    forward made them) replayed alone between CUDA events: the im2col rows,
    K2 (the fused LUT GEMM), the fake-quant activations, batch norm and
    pooling; ``other`` is the forward's time less the parts (residual adds,
    relus, reshapes, host gaps the parts do not overlap)."""
    from repro_torch.core import export, qat
    from repro_torch.nn import layers as L

    ms, _ = breakdown(torch, forward, {
        "im2col_rows": (export, "im2col_rows"),
        "k2": (export, "lut_matmul_fused"),
        "fake_quant_acts": (qat, "fake_quant_act"),
        "batch_norm": (L, "apply_batchnorm"),
        "pooling": (L, "avg_pool_global")})
    ms["batch_norm_and_pooling"] = ms.pop("batch_norm") + ms.pop("pooling")
    ms["other"] = ms["forward"] - sum(v for k, v in ms.items()
                                      if k not in ("forward", "calls"))
    return ms


def breakdown(torch, forward, targets, reps=10, replays=None):
    """({"forward": ms, part: ms, ..., "calls": {part: n}}, {part: [(args,
    kwargs)]}): ``forward()`` runs once with every ``targets`` function
    ({part: (module or object, attribute)}) recording its calls; then the
    forward and each part's recorded calls, replayed alone, are timed
    between CUDA events in interleaved turns (`time_turns`). ``replays``
    ({name: (part, make)}) times one more replay of a part's calls each:
    ``make(args, kwargs)`` prepares a call's stand-in (outside the timing)
    and returns it as a function of no arguments."""
    calls = {name: [] for name in targets}
    real = {name: getattr(mod, attr) for name, (mod, attr) in targets.items()}

    def rec(name, fn):
        def wrapped(*a, **kw):
            calls[name].append((a, kw))
            return fn(*a, **kw)
        return wrapped

    for name, (mod, attr) in targets.items():
        setattr(mod, attr, rec(name, real[name]))
    try:
        forward()
    finally:
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, real[name])

    def replay(name):
        def run():
            for a, kw in calls[name]:
                real[name](*a, **kw)
        return run

    def replay_as(part, make):
        stand_ins = [make(a, kw) for a, kw in calls[part]]

        def run():
            for fn in stand_ins:
                fn()
        return run

    fns = {"forward": forward}
    fns.update({name: replay(name) for name in targets})
    fns.update({name: replay_as(part, make)
                for name, (part, make) in (replays or {}).items()})
    ms = time_turns(torch, fns, reps)
    ms["calls"] = {name: len(v) for name, v in calls.items()}
    return ms, calls


# ------------------------------------------------------------- profile path


def stats_equal(torch, a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def profile_path(torch):
    """Run profile + energy_model on the card; returns (K1 launches, the
    per-layer main-path rows, the [mesh] profile metrics)."""
    from repro_torch.core.profiler import (
        batched_layer_stats,
        gather_layer_tiles,
        sample_tiles,
    )
    from repro_torch.core.runner import layer_seed
    from repro_torch.core.stats import TILE, pad_to_tiles
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.kernels.transition_energy import ref
    from repro_torch.kernels.transition_energy import transition_energy as k1
    from repro_torch.pipeline.config import (
        PipelineConfig,
        ProfileStageConfig,
        TargetConfig,
        TrainStageConfig,
    )
    from repro_torch.pipeline.pipeline import Pipeline

    cfg = PipelineConfig(
        target=TargetConfig(kind="cnn", arch="resnet20", batch_size=BATCH),
        train=TrainStageConfig(qat_steps=0),
        profile=ProfileStageConfig(batches=1, max_tiles=PROFILE_TILES))
    pipe = Pipeline(cfg, device="cuda")
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    plan = pipe.run_until("energy_model", verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k2_launches = k1.launches, k2.launches

    runner = pipe.target.runner
    names = [cl.name for cl in runner.model.comp_layers]
    if launches != len(names) or k2_launches != 0:
        raise AssertionError(f"expected {len(names)} K1 launches and no K2 "
                             f"launch, got {launches} and {k2_launches}")
    if sorted(plan.stats) != sorted(names) or len(names) != 22:
        raise AssertionError(f"stats for {sorted(plan.stats)}")
    for name in names:
        lut = plan.luts[name]
        if tuple(lut.shape) != (256,) or not torch.isfinite(lut).all():
            raise AssertionError(f"{name}: bad LUT {tuple(lut.shape)}")
    share_sum = sum(plan.shares.values())
    if abs(share_sum - 1.0) > 1e-6:
        raise AssertionError(f"energy shares sum to {share_sum}")

    # the stage's steps again, warm, each timed on the host clock between
    # synchronizations (where the stage's time goes)
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    parts = dict.fromkeys(("accuracy_s", "taps_s", "trace_inputs_s",
                           "k1_calls_s", "energy_models_s"), 0.0)
    _, parts["accuracy_s"] = timed(lambda: runner.accuracy(
        plan.params, plan.state, plan.comp, n_batches=cfg.train.eval_batches))
    _, parts["energy_models_s"] = timed(lambda: runner.energy_models(
        plan.params, plan.comp, plan.stats))

    # the same taps and tile indices: the card's statistics (the pipeline's
    # and a fresh launch) against the plain version on the CPU
    taps, parts["taps_s"] = timed(lambda: runner.capture_taps(
        plan.params, plan.state, plan.comp, 1))
    rows, tiles = [], 0
    for cl in runner.model.comp_layers:
        tap = taps.pop(cl.name)

        def trace_inputs():
            w_pad, x_pad = pad_to_tiles(*runner.layer_trace_inputs(cl, tap))
            total = (w_pad.shape[0] * w_pad.shape[1]
                     * x_pad.shape[1]) // TILE ** 3
            idx = sample_tiles(total, PROFILE_TILES, layer_seed(cl.name))
            return gather_layer_tiles(w_pad, x_pad, idx)

        (w_t, a_t), secs = timed(trace_inputs)
        parts["trace_inputs_s"] += secs
        mask = torch.ones(w_t.shape[0], device="cuda")
        card, secs = timed(lambda: batched_layer_stats(w_t, a_t))
        parts["k1_calls_s"] += secs
        cpu = batched_layer_stats(w_t.cpu(), a_t.cpu())
        s = plan.stats[cl.name]
        ran = (s.energy_sum, s.count, s.group_hist, s.act_hist)
        if not (stats_equal(torch, card, cpu) and stats_equal(torch, ran, cpu)):
            raise AssertionError(f"{cl.name}: card statistics differ from the "
                                 "plain version on the CPU")
        ms = time_turns(torch, {"kernel": lambda: k1.launch(w_t, a_t, mask),
                                "plain": lambda: ref.transition_counts(
                                    w_t, a_t, mask)}, REPS)
        device_ms, _ = graph_ms(torch, lambda: k1.launch(w_t, a_t, mask))
        b_ms, b_by = k1_bound(w_t, a_t, mask)
        rows.append(dict(layer=cl.name, n_tiles=int(w_t.shape[0]),
                         ms=ms["kernel"], plain_ms=ms["plain"],
                         device_ms=device_ms, bound_ms=b_ms, bound_by=b_by))
        tiles += int(w_t.shape[0])
    metrics = {k: plan.metrics[k] for k in ("wall_s_profile",
                                            "wall_s_energy_model",
                                            "acc_base",
                                            "energy_profile_total")}
    metrics.update(profile_path_wall_s=wall, k1_launches=launches,
                   tiles_traced=tiles,
                   k1_ms_stage=sum(r["ms"] for r in rows),
                   k1_device_ms_stage=sum(r["device_ms"] for r in rows),
                   k1_plain_ms_stage=sum(r["plain_ms"] for r in rows),
                   k1_bound_ms_stage=sum(r["bound_ms"] for r in rows),
                   share_sum=share_sum)
    print("[profile] " + json.dumps(metrics, sort_keys=True), flush=True)
    print("[profile-breakdown] " + json.dumps(parts, sort_keys=True),
          flush=True)
    return launches, rows, mesh_profile(torch, runner, plan)


# ------------------------------------------------------------ K3 phase


def k3_weight_shapes(comp_layers):
    """Every compressible weight's shape, in the JAX package's layout (HWIO
    conv kernels, (in, out) dense weights), in the model's order."""
    return [(cl.kernel, cl.kernel, cl.c_in, cl.c_out) if cl.kind == "conv"
            else (cl.c_in, cl.c_out) for cl in comp_layers]


def k3_shapes(comp_layers):
    """The distinct (M, N) of a CNN's weights viewed as (-1, c_out), the
    per-layer kernel's shapes, in order."""
    return sorted({(cl.kernel * cl.kernel * cl.c_in, cl.c_out)
                   for cl in comp_layers})


def leaf_bytes(v):
    """Bytes of a K3 input read once: a leaf whose candidate axis has
    stride 0 (one tensor every candidate shares) counts once; an int passed
    by value counts nothing."""
    if not hasattr(v, "element_size"):
        return 0
    if v.ndim and v.shape[0] > 1 and v.stride(0) == 0:
        v = v[0]
    return v.numel() * v.element_size()


def k3_bound(ws, comps):
    """Least time on an H100 SXM for a grouped K3 call, in ms, and what
    sets it. Bytes: every w and mask read once (a field shared by every
    candidate once), every output written once, each codebook and scalar
    read once, over HBM bandwidth. Operations: 10 float32 operations a
    weight and candidate (mask multiply, absolute value and maximum for the
    scale, division, rounding, two clip comparisons, scale multiply, the
    straight-through subtract and add) at the fp32 peak."""
    nbytes = sum(leaf_bytes(w) + 4 * w.numel()
                 + sum(leaf_bytes(c.get(key)) for key in
                       ("mask", "codebook", "codebook_k", "msr_bits"))
                 for w, c in zip(ws, comps))
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = 10.0 * sum(w.numel() for w in ws) / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def host_us(torch, fn, calls):
    """Host µs a call of ``fn``: ``calls`` back-to-back calls timed on the
    host clock up to the last enqueue (the device drains afterwards, not
    timed), so what the wrapper costs the host, whatever the kernel's
    length."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def graph_ms(torch, fn, reps=REPS):
    """(device ms of one ``fn()``, method). ``fn`` launches one short
    kernel: GRAPH_LAUNCHES calls are captured in a CUDA graph and each replay
    is timed with CUDA events (median over ``reps``), so the host's launch
    overhead between calls drops out. If the capture fails, back-to-back
    launches are timed instead, which measures the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_LAUNCHES):
                fn()
        run, method = graph.replay, "cuda graph"
    except RuntimeError as e:
        print(f"[graph] capture failed ({e}); timing launches from the "
              "host", flush=True)
        torch.cuda.synchronize()

        def run():
            for _ in range(GRAPH_LAUNCHES):
                fn()
        method = "host launches"
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_LAUNCHES)
    return statistics.median(times), method


def k3_cases(torch, comp_layers):
    """[(label, w, mask, scale, codebook, k, msr_bits)] for the per-layer
    kernel: every weight shape of ResNet-20 viewed as (-1, c_out) with k in
    {0, 5, 16, 32} and MSR depths {0, 3} on a 50% mask, k and the depth as
    int32 device scalars; an int8 mask with k and the depth by value;
    rounding ties; the clip; a NaN weight at a finite scale."""
    from repro_torch.core import qat
    from repro_torch.core.schedule import symmetric_codebook_values

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(11)

    def codebook(values):
        return qat.make_codebook(values, device=dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    books = {k: codebook(symmetric_codebook_values(k) if k else [])
             for k in (0, 5, 16, 32)}
    cases = []
    for m, n in k3_shapes(comp_layers):
        w = torch.randn((m, n), generator=gen, device=dev) * 0.1
        mask = (torch.rand((m, n), generator=gen, device=dev) < 0.5).float()
        scale = qat.weight_scale(w * mask)[0]
        for k, (cb, k_t) in books.items():
            for msr in (0, 3):
                cases.append((f"{m}x{n} k={k} msr={msr}", w, mask, scale, cb,
                              k_t, scalar(msr)))
    cases.append(("576x64 int8 mask, k=16 msr=3 by value", w,
                  mask.to(torch.int8), scale, books[16][0], 16, 3))
    ties = torch.cat([torch.arange(-40, 40, device=dev) + 0.5,
                      torch.arange(-40, 40, device=dev).float()])
    ties = ties.reshape(-1, 8).contiguous()
    cb, k_t = codebook([-30, -10, 0, 10, 30])
    cases.append(("ties: w/scale = x.5, codebook midpoints", ties,
                  torch.ones_like(ties), torch.ones(8, device=dev), cb, k_t,
                  scalar(0)))
    big = torch.randn((64, 16), generator=gen, device=dev) * 4.0
    cb, k_t = codebook([-127, -100, 0, 100, 126])
    cases.append(("clip: |w/scale| up to ~1000", big, torch.ones_like(big),
                  torch.full((16,), 0.01, device=dev), cb, k_t, scalar(0)))
    nan = big.clone()
    nan[9, 2] = float("nan")        # q of NaN is 0, as in the plain version
    cases.append(("a NaN weight at a finite scale", nan, torch.ones_like(nan),
                  torch.full((16,), 0.05, device=dev), cb, k_t, scalar(0)))
    return cases


def k3_phase(torch, cases):
    """The per-layer kernel (the serve path's unserved layers, and the
    caller-scale API) against its plain version, bit for bit."""
    from repro_torch.kernels.fake_quant import ops, ref

    rows = []
    for label, w, mask, scale, cb, k, msr in cases:
        got = ops.fake_quant_project(w, mask, scale, cb, k, msr)
        want = ref.fake_quant_ref(w, mask, scale, cb, k, msr)
        torch.cuda.synchronize()
        max_err = float((got - want).abs().max())
        if not equal_nan(torch, got, want):
            raise AssertionError(
                f"K3 {label}: kernel differs from the plain version (max abs "
                f"err {max_err:.3e}; required: equal)")
        rows.append(dict(case=f"per-layer {label}", max_abs_err=max_err))
        print(f"[k3] per-layer {label:<40} err={max_err:.1e}", flush=True)
    return rows


def k3_group_cases(torch, comp_layers):
    """[(label, ws, comps)] for the grouped kernel: every ResNet-20 weight
    in one group with k in {0, 5, 16, 32} and MSR depths {0, 3} on a 50%
    mask (k and the depth as int32 device scalars, as the QAT path passes
    them); an int8 mask with k and the depth by value; ragged shapes; ties
    (w / scale exactly x.5, values exactly between codebook entries); large
    magnitudes; a NaN weight (its column NaN, as in the plain version)."""
    from repro_torch.core import qat
    from repro_torch.core.schedule import symmetric_codebook_values

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(12)

    def comp(w, values=(), msr=0, mask=None, by_value=False):
        c = qat.identity_comp(tuple(w.shape), device=dev)
        if values:
            c["codebook"], c["codebook_k"] = qat.make_codebook(values,
                                                               device=dev)
        if mask is not None:
            c["mask"] = mask
        c["msr_bits"] = torch.tensor(msr, dtype=torch.int32, device=dev)
        if by_value:
            c["codebook_k"], c["msr_bits"] = len(values), msr
        return c

    ws = [torch.randn(s, generator=gen, device=dev) * 0.1
          for s in k3_weight_shapes(comp_layers)]
    masks = [(torch.rand(w.shape, generator=gen, device=dev) < 0.5).float()
             for w in ws]
    cases = []
    for k in (0, 5, 16, 32):
        values = symmetric_codebook_values(k) if k else ()
        for msr in (0, 3):
            cases.append((f"resnet20, 22 layers, k={k} msr={msr}", ws,
                          [comp(w, values, msr=msr, mask=m)
                           for w, m in zip(ws, masks)]))
    cases.append(("resnet20, int8 mask, k=16 msr=3 by value", ws,
                  [comp(w, symmetric_codebook_values(16), msr=3,
                        mask=m.to(torch.int8), by_value=True)
                   for w, m in zip(ws, masks)]))
    ragged = [torch.randn(s, generator=gen, device=dev)
              for s in ((7, 37), (5,), (1, 1), (3, 3, 5, 70), (300, 9))]
    cases.append(("ragged shapes", ragged,
                  [comp(w, symmetric_codebook_values(5)) for w in ragged]))
    ties = torch.cat([torch.arange(-40, 40, device=dev) + 0.5,
                      torch.arange(-40, 40, device=dev).float(),
                      torch.full((8,), 127.0, device=dev)])   # scale = 1
    ties = ties.reshape(-1, 8).contiguous()
    big = torch.randn((64, 16), generator=gen, device=dev) * 4.0
    cases.append(("ties and large magnitudes", [ties, big],
                  [comp(ties, (-30, -10, 0, 10, 30)),
                   comp(big, (-127, -100, 0, 100, 126))]))
    nan = torch.randn((40, 12), generator=gen, device=dev)
    nan[17, 3] = float("nan")      # its column's scale, and column, is NaN
    nan[5, 8] = float("nan")       # NaN * 0 is NaN: masked out, still NaN
    nan_mask = torch.ones_like(nan)
    nan_mask[5, 8] = 0.0
    cases.append(("one NaN weight a column", [nan, big],
                  [comp(nan, symmetric_codebook_values(16), mask=nan_mask),
                   comp(big, symmetric_codebook_values(5))]))
    return cases


def equal_nan(torch, a, b):
    """``a`` equals ``b`` bit for bit where neither is NaN, and both are
    NaN at the same places."""
    nan = a.isnan()
    return (torch.equal(nan, b.isnan())
            and torch.equal(a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0)))


def k3_group_phase(torch, comp_layers):
    """The grouped kernel against its plain version on `k3_group_cases`,
    bit for bit, one launch a group; then, on one ResNet-20 QAT forward's
    22 weights (k = 16, 50% mask), device time of one grouped call in a
    CUDA graph and host time a call, beside the per-layer path it replaced,
    in the same run: its 22 kernel launches alone and its 22
    `qat.fake_quant_weight` chains (kernel plus the eager mask, scale and
    straight-through ops around it), device and host. Timing launches are
    not counted as the main path's."""
    from repro_torch.core import qat
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.fake_quant import ref

    rows = []
    cases = k3_group_cases(torch, comp_layers)
    for label, ws, comps in cases:
        launched = k3.launches
        got = qat.fake_quant_weights(ws, comps)
        if k3.launches - launched != 1:
            raise AssertionError(f"K3 group {label}: "
                                 f"{k3.launches - launched} launches")
        torch.cuda.synchronize()
        max_err = 0.0
        for i, (w, c, g) in enumerate(zip(ws, comps, got)):
            want = ref.fake_quant_ste_ref(w, c)
            max_err = max(max_err, float((g - want).abs().nan_to_num(
                nan=0.0).max()))
            if not equal_nan(torch, g, want):
                raise AssertionError(
                    f"K3 group {label}, entry {i} {tuple(w.shape)}: kernel "
                    f"differs from the plain version (max abs err "
                    f"{max_err:.3e}; required: equal)")
        rows.append(dict(case=f"grouped {label}", layers=len(ws),
                         max_abs_err=max_err))
        print(f"[k3] grouped {label:<42} x{len(ws):<2} err={max_err:.1e}",
              flush=True)

    ws, comps = next(c[1:] for c in cases if c[0].endswith("k=16 msr=0"))
    launched = k3.launches

    scales = [qat.weight_scale(w * c["mask"]).reshape(-1)
              for w, c in zip(ws, comps)]

    def grouped():
        qat.fake_quant_weights(ws, comps)

    def per_layer_kernels():
        for w, c, sc in zip(ws, comps, scales):
            n = w.shape[-1]
            k3.launch(w.reshape(-1, n), c["mask"].reshape(-1, n), sc,
                      c["codebook"], c["codebook_k"], c["msr_bits"])

    def per_layer_chains():
        for w, c in zip(ws, comps):
            qat.fake_quant_weight(w, c)

    with torch.no_grad():
        out = {}
        out["device_ms"], out["timing"] = graph_ms(torch, grouped)
        out["per_layer_kernels_device_ms"], _ = graph_ms(torch,
                                                         per_layer_kernels)
        out["per_layer_chains_device_ms"], _ = graph_ms(torch,
                                                        per_layer_chains)
        out["host_us_per_call"] = host_us(torch, grouped, HOST_CALLS)
        out["per_layer_chains_host_us"] = host_us(torch, per_layer_chains,
                                                  HOST_CALLS // 4)
        out["plain_ms"] = time_turns(torch, {"plain": lambda: [
            ref.fake_quant_ste_ref(w, c) for w, c in zip(ws, comps)]},
            REPS)["plain"]
    k3.launches = launched
    out["bound_ms"], out["bound_by"] = k3_bound(ws, comps)
    out["weights"] = sum(w.numel() for w in ws)
    print(f"[k3] one ResNet-20 forward, 22 layers: grouped "
          f"{1e3 * out['device_ms']:.2f} us device ({out['timing']}), "
          f"{out['host_us_per_call']:.1f} us host a call; per-layer kernels "
          f"{1e3 * out['per_layer_kernels_device_ms']:.2f} us device; "
          f"per-layer chains {1e3 * out['per_layer_chains_device_ms']:.2f} "
          f"us device, {out['per_layer_chains_host_us']:.1f} us host; plain "
          f"{out['plain_ms']:.4f} ms; bound {1e3 * out['bound_ms']:.3f} us "
          f"({out['bound_by']})", flush=True)
    return rows, out


def k3_candidate_cases(torch, comp_layers, n):
    """[(label, ws, comps)] for the grouped kernel with a candidate axis of
    ``n`` over ResNet-20's 22 weights: every field per candidate (weights,
    50% masks, and per candidate a k of {0, 5, 16, 32} and an MSR depth of
    {0, 3} as int32 device tensors: the batched sweep's trial forwards);
    then the same with shared (stride-0) fields mixed in layer by layer: a
    shared weight and mask (comp variants of one model), a shared codebook
    and depth with k by value, every comp field shared (a layer the sweep
    does not search)."""
    from repro_torch.core import qat
    from repro_torch.core.schedule import symmetric_codebook_values

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(13 + n)
    books = [qat.make_codebook(symmetric_codebook_values(k) if k else [],
                               device=dev) for k in (0, 5, 16, 32)]
    ws, per = [], []
    for shape in k3_weight_shapes(comp_layers):
        w = torch.randn((n,) + shape, generator=gen, device=dev) * 0.1
        pick = torch.randint(0, 4, (n,), generator=gen, device=dev).tolist()
        depth = torch.randint(0, 2, (n,), generator=gen, device=dev) * 3
        ws.append(w)
        per.append({
            "mask": (torch.rand(w.shape, generator=gen, device=dev)
                     < 0.5).float(),
            "codebook": torch.stack([books[j][0] for j in pick]),
            "codebook_k": torch.stack([books[j][1] for j in pick]),
            "msr_bits": depth.to(device=dev, dtype=torch.int32)})
    mixed_ws, mixed = [], []
    for i, (w, c) in enumerate(zip(ws, per)):
        kind = i % 4
        if kind == 0:
            w, c = w[0][None].expand_as(w), dict(c, mask=c["mask"][0])
        elif kind == 1:
            c = dict(c, codebook=c["codebook"][0][None].expand(n, 32),
                     msr_bits=c["msr_bits"][0],
                     codebook_k=int(c["codebook_k"][0]))
        elif kind == 2:
            c = {key: v[0][None].expand_as(v) for key, v in c.items()}
        mixed_ws.append(w)
        mixed.append(c)
    return [(f"{n} candidates, every field per candidate", ws, per),
            (f"{n} candidates, shared fields mixed in", mixed_ws, mixed)]


def k3_candidate_phase(torch, comp_layers):
    """The grouped kernel with a candidate axis (the batched schedule
    sweep's forwards) against its plain version, bit for bit, at
    K3_CANDIDATES candidates of ResNet-20's 22 weights, one launch a call;
    then, on the case with every field per candidate, device time of one
    call in a CUDA graph beside its bound and beside the n single-candidate
    grouped calls it replaces, in the same run, the host time of a call and
    the plain version's time. Timing launches are not counted as a main
    path's."""
    from repro_torch.core import qat
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.fake_quant import ref

    rows, timed = [], []
    launched = k3.launches
    for n in K3_CANDIDATES:
        cases = k3_candidate_cases(torch, comp_layers, n)
        for label, ws, comps in cases:
            before = k3.launches
            got = qat.fake_quant_weights(ws, comps, cands=n)
            if k3.launches - before != 1:
                raise AssertionError(f"K3 {label}: {k3.launches - before} "
                                     "launches, expected 1")
            torch.cuda.synchronize()
            want = ref.fake_quant_group_ref(ws, comps, n)
            max_err = 0.0
            for i, (g, r) in enumerate(zip(got, want)):
                max_err = max(max_err, float((g - r).abs().max()))
                if not equal_nan(torch, g, r):
                    raise AssertionError(
                        f"K3 {label}, entry {i} {tuple(g.shape)}: kernel "
                        f"differs from the plain version (max abs err "
                        f"{max_err:.3e}; required: equal)")
            rows.append(dict(case=f"grouped, {label}", layers=len(ws),
                             candidates=n, max_abs_err=max_err))
            print(f"[k3-cand] {label:<46} err={max_err:.1e}", flush=True)

        _, ws, comps = cases[0]
        singles = [([w[j] for w in ws],
                    [ref.candidate_comp(c, w.ndim - 1, j)
                     for w, c in zip(ws, comps)]) for j in range(n)]

        def grouped():
            qat.fake_quant_weights(ws, comps, cands=n)

        def separate():
            for ws_j, comps_j in singles:
                qat.fake_quant_weights(ws_j, comps_j)

        with torch.no_grad():
            out = dict(candidates=n, weights=sum(w.numel() for w in ws))
            out["device_ms"], out["timing"] = graph_ms(torch, grouped)
            out["separate_device_ms"], _ = graph_ms(torch, separate)
            out["host_us_per_call"] = host_us(torch, grouped,
                                              HOST_CALLS // 4)
            out["plain_ms"] = time_turns(torch, {"plain": lambda: (
                ref.fake_quant_group_ref(ws, comps, n))}, 3)["plain"]
        out["bound_ms"], out["bound_by"] = k3_bound(ws, comps)
        timed.append(out)
        print(f"[k3-cand] {n} candidates x 22 layers: one launch "
              f"{1e3 * out['device_ms']:.2f} us device ({out['timing']}), "
              f"{out['host_us_per_call']:.1f} us host; {n} single-candidate "
              f"launches {1e3 * out['separate_device_ms']:.2f} us device; "
              f"plain {out['plain_ms']:.3f} ms; bound "
              f"{1e3 * out['bound_ms']:.3f} us ({out['bound_by']})",
              flush=True)
    k3.launches = launched
    return rows, timed


# --------------------------------------------------------------- train step


def leaves(tree, prefix=""):
    """{path: tensor} of a nested dict of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


def restricted_comp(torch, model, params, device):
    """Every layer restricted to 16 int8 values, ``s2b2/conv1`` pruned 50%,
    ``s3b1/conv2`` truncated to 3 MSR bits: a comp state that takes K3
    through projection, mask and truncation."""
    from repro_torch.core import qat
    from repro_torch.core.schedule import symmetric_codebook_values

    comp = {}
    for cl in model.comp_layers:
        w = model.get_weight(params, cl.name)
        c = qat.identity_comp(tuple(w.shape), device=device)
        c["codebook"], c["codebook_k"] = qat.make_codebook(
            symmetric_codebook_values(16), device=device)
        if cl.name == "s2b2/conv1":
            c["mask"] = qat.magnitude_prune_mask(w, 0.5)
        if cl.name == "s3b1/conv2":
            c["msr_bits"] = torch.tensor(3, dtype=torch.int32, device=device)
        comp[cl.name] = c
    return comp


def step_breakdown(torch, runner, params, state, opt_state, comp, batch):
    """ms of one warm QAT step and of its parts, each part run alone at the
    step's own shapes (forward and backward) between CUDA events:
    convolutions, fake-quant activations, batch norm, the weight fake-quant
    (the grouped call with its straight-through backward), the grouped K3
    launch alone, the optimizer. Alone, each part's host launch gaps show
    in its time, while the step overlaps them with device work, so
    ``parts_sum`` may exceed ``step``."""
    from repro_torch.core import qat
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.nn import layers as L
    from repro_torch.optim.optimizers import apply_updates

    calls = {"conv": [], "act": [], "bn": [], "weight": []}
    real = (L.conv_nhwc, qat.fake_quant_act, L.apply_batchnorm,
            qat.fake_quant_weights)

    def rec(kind, fn):
        def wrapped(*a, **kw):
            calls[kind].append((a, kw))
            return fn(*a, **kw)
        return wrapped

    L.conv_nhwc = rec("conv", real[0])
    qat.fake_quant_act = rec("act", real[1])
    L.apply_batchnorm = rec("bn", real[2])
    qat.fake_quant_weights = rec("weight", real[3])
    try:
        runner.loss_and_grads(params, state, comp, batch)
    finally:
        (L.conv_nhwc, qat.fake_quant_act, L.apply_batchnorm,
         qat.fake_quant_weights) = real

    grad_args = {"conv": (0, 1), "act": (0,), "bn": (0, 2), "weight": (0,)}

    def prep(v, grad):
        """A recorded argument cut from the step's graph; a leaf that needs
        a gradient where the step computes one."""
        if isinstance(v, torch.Tensor):
            v = v.detach()
            return v.requires_grad_(True) if grad and v.is_floating_point() \
                else v
        if isinstance(v, dict):
            return {k: prep(x, grad) for k, x in v.items()}
        if isinstance(v, list):
            return [prep(x, grad) for x in v]
        return v

    def fwd_bwd(kind, fn):
        def run():
            for a, kw in calls[kind]:
                out = fn(*[prep(v, i in grad_args[kind])
                           for i, v in enumerate(a)], **kw)
                outs = out if isinstance(out, list) else [
                    out[0] if isinstance(out, tuple) else out]
                torch.autograd.backward(outs,
                                        [torch.ones_like(o) for o in outs])
        return run

    def k3_alone():
        for (ws, comps, cands), _ in calls["weight"]:
            k3.launch_group([w.detach() for w in ws], comps, cands)

    loss, grads, _ = runner.loss_and_grads(params, state, comp, batch)

    def optimizer():
        updates, _ = runner.optimizer.update(grads, opt_state, params)
        apply_updates(params, updates)

    parts = time_turns(torch, {
        "step": lambda: runner.train_step(params, state, opt_state, comp,
                                          batch),
        "convs": fwd_bwd("conv", real[0]),
        "fake_quant_acts": fwd_bwd("act", real[1]),
        "batch_norm": fwd_bwd("bn", real[2]),
        "weight_fake_quant": fwd_bwd("weight", real[3]),
        "k3_kernel": k3_alone,
        "optimizer": optimizer}, 5)
    parts["parts_sum"] = sum(v for k, v in parts.items()
                             if k not in ("step", "k3_kernel"))
    parts["calls"] = {k: len(v) for k, v in calls.items()}
    return parts


def kernel_category(name):
    n = name.lower()
    if "fake_quant" in n:
        return "k3"
    if any(t in n for t in ("conv", "cudnn", "gemm", "dgrad", "wgrad", "xmma",
                            "implicit", "winograd", "im2col", "col2im")):
        return "convs"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "reduce" in n:
        return "reductions"
    return "elementwise"


def device_split(torch, fn, steps=3):
    """Device ms per ``fn()`` by kernel category (from torch.profiler's
    CUPTI kernel records), the top kernels, and the device's idle share of
    the window (wall time under the profiler, so an upper bound). Returns
    None if the profiler reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3 / steps
    busy = sum(kernels.values())
    if busy <= 0:
        return None
    cats = {}
    for name, ms in kernels.items():
        cats[kernel_category(name)] = cats.get(kernel_category(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=max(0.0, 1.0 - busy / wall_ms),
                by_category=cats, n_kernel_names=len(kernels),
                top_kernels=[[name[:90], ms] for name, ms in top])


def train_phase(torch):
    """The card's QAT step against the CPU's, then warm steps at batch 256.
    Returns the [train] metrics."""
    from repro_torch._device import tree_to
    from repro_torch.core.runner import CnnRunner
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.nn.cnn import resnet20

    data = SyntheticImages(seed=7)
    cpu = CnnRunner(resnet20(), data, batch_size=TRAIN_CHECK_BATCH,
                    device="cpu")
    params, state, _, _ = cpu.init()
    comp = restricted_comp(torch, cpu.model, params, "cpu")
    batch = data.batch(0, TRAIN_CHECK_BATCH, "train", device="cpu")
    t0 = time.perf_counter()
    cpu_loss, cpu_grads, _ = cpu.loss_and_grads(params, state, comp, batch)
    cpu_s = time.perf_counter() - t0
    card = CnnRunner(resnet20(), data, batch_size=TRAIN_CHECK_BATCH,
                     device="cuda")
    k3.launches = 0
    card_loss, card_grads, _ = card.loss_and_grads(
        *(tree_to(t, "cuda") for t in (params, state, comp, batch)))
    torch.cuda.synchronize()
    if k3.launches != 1:
        raise AssertionError(f"card step launched K3 {k3.launches} times, "
                             "expected 1")
    loss_rel = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    grad_rel = {}
    cpu_leaves = leaves(cpu_grads)
    for name, g in leaves(card_grads).items():
        want = cpu_leaves[name].double()
        grad_rel[name] = float(torch.linalg.norm(g.cpu().double() - want)
                               / torch.clamp(torch.linalg.norm(want),
                                             min=1e-30))
    worst = max(grad_rel, key=grad_rel.get)
    print(f"[train] card vs CPU, batch {TRAIN_CHECK_BATCH}: loss "
          f"{float(card_loss):.6f} vs {float(cpu_loss):.6f} (rel "
          f"{loss_rel:.2e}), worst gradient leaf {worst} rel-L2 "
          f"{grad_rel[worst]:.2e} (CPU step {cpu_s:.2f} s)", flush=True)
    if not (loss_rel <= LOSS_RTOL and grad_rel[worst] <= GRAD_RTOL):
        raise AssertionError(
            f"card QAT step disagrees with the CPU: loss rel {loss_rel:.3e} "
            f"(<= {LOSS_RTOL}), {worst} rel-L2 {grad_rel[worst]:.3e} "
            f"(<= {GRAD_RTOL})")

    # warm QAT steps at batch 256 from a fresh init (identity comps, as the
    # base training of the profile stage runs)
    runner = CnnRunner(resnet20(), data, batch_size=BATCH, device="cuda")
    params, state, opt_state, comp = runner.init()
    batch = data.batch(0, BATCH, "train", device="cuda")
    for _ in range(2):
        params, state, opt_state, _ = runner.train_step(
            params, state, opt_state, comp, batch)
    torch.cuda.synchronize()
    n_steps = 5
    k3.launches = 0
    t0 = time.perf_counter()
    for _ in range(n_steps):
        params, state, opt_state, loss = runner.train_step(
            params, state, opt_state, comp, batch)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    per_step = k3.launches / n_steps
    t0 = time.perf_counter()
    params, state, opt_state, _ = runner.train(params, state, opt_state,
                                               comp, n_steps)
    torch.cuda.synchronize()
    train_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    k3.launches = 0
    with torch.no_grad():
        runner.model.apply(params, state, batch[0], train=False,
                           qcfg=runner.qcfg, comp=comp)
    torch.cuda.synchronize()
    per_eval = k3.launches
    if per_step != 1 or per_eval != 1:
        raise AssertionError(f"K3 launches: {per_step} per train step and "
                             f"{per_eval} per eval forward, expected 1 each")
    torch.cuda.reset_peak_memory_stats()
    parts = step_breakdown(torch, runner, params, state, opt_state, comp,
                           batch)
    try:
        split = device_split(torch, lambda: runner.train_step(
            params, state, opt_state, comp, batch))
    except Exception as e:      # the profiler is optional here
        split = None
        print(f"[train-device] profiler failed: {e!r}", flush=True)
    print("[train-device] " + (json.dumps(split, sort_keys=True) if split
                               else "not measured (no device time)"),
          flush=True)
    metrics = dict(check_batch=TRAIN_CHECK_BATCH, loss_rel=loss_rel,
                   worst_grad_leaf=worst, worst_grad_rel=grad_rel[worst],
                   batch=BATCH, step_ms=step_ms,
                   train_ms_per_step_with_data=train_ms,
                   k3_launches_per_step=per_step,
                   k3_launches_per_eval_forward=per_eval,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("[train] " + json.dumps(metrics, sort_keys=True), flush=True)
    print("[train-breakdown] " + json.dumps(parts, sort_keys=True),
          flush=True)
    return metrics, parts


# ------------------------------------------------------------ compress path


def compress_config(search_mode=None, **schedule):
    """The compress path's ResNet-20 config at batch 256: 20 QAT steps,
    16 tiles a layer, the schedule on the two layers of largest share (prune
    0.5, k 16 unless ``schedule`` says otherwise), 5 final fine-tune steps.
    ``search_mode`` None keeps the default (batched)."""
    from repro_torch.pipeline.config import (
        PipelineConfig,
        ProfileStageConfig,
        ScheduleConfig,
        SelectionConfig,
        TargetConfig,
        TrainStageConfig,
    )

    schedule = dict(dict(prune_ratios=(0.5,), k_targets=(16,),
                         delta_acc=0.08, finetune_steps=10,
                         trial_finetune_steps=8, eval_batches=1,
                         max_layers=2), **schedule)
    if search_mode is not None:
        schedule["search_mode"] = search_mode
    return PipelineConfig(
        target=TargetConfig(kind="cnn", arch="resnet20", batch_size=BATCH),
        train=TrainStageConfig(qat_steps=20, final_finetune_steps=5,
                               eval_batches=2),
        profile=ProfileStageConfig(batches=1, max_tiles=PROFILE_TILES),
        schedule=ScheduleConfig(**schedule),
        selection=SelectionConfig(k_init=20, k_target=16, delta_acc=0.08,
                                  score_batches=1, accept_batches=1,
                                  max_score_candidates=3))


def comp_digest(comp):
    """sha256 of every layer's mask, codebook, k and MSR depth: a
    schedule's result in one digest."""
    digest = hashlib.sha256()
    for name in sorted(comp):
        for key in ("mask", "codebook", "codebook_k", "msr_bits"):
            v = comp[name].get(key)
            if v is not None:
                digest.update(v.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def counting_forwards(model, forwards):
    """Wrap ``model.apply`` to count its fake-quant forwards by kind into
    ``forwards`` ("fake_quant", "serve", and "candidates" for those of a
    candidate axis, which are fake-quant forwards too); returns the real
    apply, to restore."""
    from repro_torch.nn.layers import QuantConfig

    real_apply = model.apply

    def counting_apply(*args, qcfg=QuantConfig.off(), cands=None, **kw):
        if qcfg.enabled:
            forwards["serve" if qcfg.comp_mode == "serve"
                     else "fake_quant"] += 1
            forwards["candidates"] += cands is not None
        return real_apply(*args, qcfg=qcfg, cands=cands, **kw)

    model.apply = counting_apply
    return real_apply


def compress_path(torch, search_mode=None):
    """``Pipeline(cfg, device="cuda").run()``: all five stages on ResNet-20
    at batch 256 (`compress_config`; ``search_mode`` None: the default
    batched sweep, as users run it), every kernel's launches and the
    model's forwards (fake-quant, serve mode, and those of a candidate
    axis) read per stage. Returns (the kernels' launches over the run,
    per-stage launches, per-stage forwards)."""
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.kernels.transition_energy import transition_energy as k1
    from repro_torch.pipeline.pipeline import Pipeline
    from repro_torch.pipeline.schema import STAGES

    cfg = compress_config(search_mode)
    pipe = Pipeline(cfg, device="cuda")
    runner = pipe.target.runner
    # the first QAT step's loss: the stage's init and first batch
    p0, s0, _, c0 = runner.init()
    first_loss = float(runner.loss_and_grads(
        p0, s0, c0, runner.dataset.batch(0, BATCH, "train",
                                         device="cuda"))[0])
    del p0, s0, c0

    kernels = {"K1": k1, "K2": k2, "K3": k3}
    # forwards by kind, counted where the model runs, to hold K3's launches
    # to: one a fake-quant forward (a QAT step's or an evaluation's, of one
    # model or of a candidate axis), and one a serve-mode forward that
    # leaves a layer unserved
    forwards = {"fake_quant": 0, "serve": 0, "candidates": 0}

    per_stage, forwards_per_stage = {}, {}
    for stage in STAGES:
        def counted(plan, cfg, verbose=False, _stage=stage,
                    _fn=getattr(pipe.target, f"stage_{stage}")):
            before = {key: mod.launches for key, mod in kernels.items()}
            fwd_before = dict(forwards)
            _fn(plan, cfg, verbose=verbose)
            per_stage[_stage] = {key: mod.launches - before[key]
                                 for key, mod in kernels.items()}
            forwards_per_stage[_stage] = {key: forwards[key] - fwd_before[key]
                                          for key in forwards}
        setattr(pipe.target, f"stage_{stage}", counted)

    for mod in kernels.values():
        mod.launches = 0
    real_apply = counting_forwards(runner.model, forwards)
    try:
        t0 = time.perf_counter()
        plan = pipe.run(verbose=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        runner.model.apply = real_apply
    totals = {key: mod.launches for key, mod in kernels.items()}

    m = plan.metrics
    n_art = len(plan.artifacts or {})
    if not n_art:
        raise AssertionError(
            "the schedule left no layer servable (accepted with a codebook "
            f"of <= 16 values): decisions {plan.decisions}")
    serve_fwds = 1 + cfg.train.eval_batches
    want_fwds = {
        "profile": {"fake_quant": cfg.train.qat_steps + cfg.train.eval_batches
                    + cfg.profile.batches, "serve": 0, "candidates": 0},
        "energy_model": {"fake_quant": 0, "serve": 0, "candidates": 0},
        "export": {"fake_quant": 0, "serve": 0, "candidates": 0},
        "serve": {"fake_quant": 1, "serve": serve_fwds, "candidates": 0},
    }
    for stage, want in want_fwds.items():
        if forwards_per_stage[stage] != want:
            raise AssertionError(f"{stage}: forwards "
                                 f"{forwards_per_stage[stage]}, expected "
                                 f"{want}")
    expect = {
        "profile": {"K1": 22, "K2": 0},
        "energy_model": {"K1": 0, "K2": 0},
        "schedule": {"K1": 0, "K2": 0},
        "export": {"K1": 0, "K2": 0},
        "serve": {"K1": 0, "K2": n_art * serve_fwds},
    }
    for stage, want in expect.items():
        f = forwards_per_stage[stage]
        want = dict(want, K3=f["fake_quant"] + (n_art < 22) * f["serve"])
        if per_stage[stage] != want:
            raise AssertionError(f"{stage}: launches {per_stage[stage]}, "
                                 f"expected {want} (forwards {f})")
    sched = forwards_per_stage["schedule"]
    if not sched["fake_quant"]:
        raise AssertionError("schedule: no fake-quant forward")
    if bool(sched["candidates"]) != (cfg.schedule.search_mode == "batched"):
        raise AssertionError(f"schedule ({cfg.schedule.search_mode}): "
                             f"{sched['candidates']} candidate-axis forwards")
    if totals != {key: sum(v[key] for v in per_stage.values())
                  for key in kernels}:
        raise AssertionError(f"launch totals {totals} != the stages' sum")
    loss = m["qat_loss"]
    if not (np.isfinite(loss) and loss < first_loss):
        raise AssertionError(f"qat_loss {loss} is not finite and below the "
                             f"first step's {first_loss}")
    rel = m["serve_logit_rel_err"]
    if not rel < 2e-2:
        raise AssertionError(f"serve_logit_rel_err {rel} >= 2e-2")
    for key in ("acc_base", "acc0", "acc_final", "energy_saving"):
        if not np.isfinite(m[key]):
            raise AssertionError(f"{key} = {m[key]}")

    out = {k: v for k, v in m.items() if k.startswith("wall_s_")}
    out.update({k: m[k] for k in (
        "qat_loss", "acc_base", "acc0", "acc_final", "accuracy_drop",
        "energy_before", "energy_after", "energy_saving",
        "serve_logit_rel_err", "serve_accuracy", "export_layers")})
    out.update(search_mode=cfg.schedule.search_mode,
               first_step_loss=first_loss, compress_path_wall_s=wall,
               launches=totals, launches_per_stage=per_stage,
               forwards_per_stage=forwards_per_stage,
               comp_sha256=comp_digest(plan.comp),
               decisions=[{k: d[k] for k in ("layer", "share", "prune_ratio",
                                              "k", "msr", "accepted",
                                              "accuracy")}
                          for d in plan.decisions])
    print("[compress] " + json.dumps(out, sort_keys=True), flush=True)
    return totals, per_stage, forwards_per_stage


def sweep_phase(torch, plan_dir):
    """The schedule stage in both search modes on one plan: ResNet-20 at
    batch 256 through ``energy_model`` once (`compress_config` with prune
    (0.7, 0.5, 0.3) x k (16, 24): 6 candidates a layer), saved, then
    ``Pipeline.from_plan(..., device="cuda").run_until("schedule")`` under
    the serial walk and under the batched sweep. Holds the decisions
    (layer, prune, k, MSR depth, accepted) and the masks and codebooks
    (`comp_digest`) equal, and K3 to one launch a forward, a candidate
    axis's included; prints each mode's schedule wall time and trials/s (a
    trial: one (layer, candidate) fine-tune with its weight selection and
    accept check). Each run's schedule stage runs under deterministic
    algorithms (`_Deterministic`): with PyTorch's defaults cuDNN's float64
    convolution backward may sum in another order on a run, and a float32
    rounding it moves can flip an int8 activation code and part the runs'
    params (seen once on an H100: decisions and masks equal, params not);
    `conv_backward_repeats` reports how many distinct results that backward
    gives over repeats under either setting. Returns the [sweep] metrics."""
    from repro_torch._device import tree_leaves
    from repro_torch.distributed.sharding import sweep_mesh
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.pipeline.pipeline import Pipeline
    from repro_torch.pipeline.plan import CompressionPlan

    base = compress_config(prune_ratios=(0.7, 0.5, 0.3), k_targets=(16, 24))
    n_cands = (len(base.schedule.prune_ratios) * len(base.schedule.k_targets)
               * len(base.schedule.msr_bits))
    Pipeline(base, device="cuda").run_until("energy_model").save(plan_dir)
    torch.cuda.empty_cache()
    runs, plans = {}, {}
    for mode, shards in (("serial", None), ("batched", None),
                         ("batched_mesh", MESH_SHARDS)):
        cfg = base.with_overrides({"schedule": {
            "search_mode": "serial" if mode == "serial" else "batched"}})
        pipe = Pipeline.from_plan(CompressionPlan.load(plan_dir), cfg=cfg,
                                  device="cuda")
        if shards:
            pipe.target.runner.sweep_mesh = card_mesh(torch, sweep_mesh,
                                                      shards)
        forwards = {"fake_quant": 0, "serve": 0, "candidates": 0}
        model = pipe.target.runner.model
        real_apply = counting_forwards(model, forwards)
        k3.launches = 0
        try:
            t0 = time.perf_counter()
            with _Deterministic(torch):
                plan = pipe.run_until("schedule")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            model.apply = real_apply
        launches = k3.launches
        if launches != forwards["fake_quant"]:
            raise AssertionError(f"sweep ({mode}): {launches} K3 launches for "
                                 f"{forwards['fake_quant']} forwards "
                                 "(expected one a forward)")
        swept = [d for d in plan.decisions if d["tried"]]
        trials = (sum(len(d["tried"]) for d in swept) if mode == "serial"
                  else n_cands * len(swept))
        runs[mode] = dict(
            wall_s_schedule=wall, trials=trials, trials_per_s=trials / wall,
            k3_launches=launches, forwards=dict(forwards),
            comp_sha256=comp_digest(plan.comp),
            decisions=[{k: d[k] for k in ("layer", "prune_ratio", "k", "msr",
                                          "accepted", "accuracy")}
                       for d in plan.decisions])
        plans[mode] = plan
        torch.cuda.empty_cache()
    key = ("layer", "prune_ratio", "k", "msr", "accepted")
    ser, bat = runs["serial"], runs["batched"]
    if ([{k: d[k] for k in key} for d in ser["decisions"]]
            != [{k: d[k] for k in key} for d in bat["decisions"]]):
        raise AssertionError(f"sweep: batched decisions {bat['decisions']} "
                             f"!= serial {ser['decisions']}")
    if ser["comp_sha256"] != bat["comp_sha256"]:
        raise AssertionError("sweep: batched masks/codebooks differ from the "
                             "serial walk's")
    if not bat["forwards"]["candidates"]:
        raise AssertionError("sweep: the batched run made no candidate-axis "
                             "forward")
    mesh = runs.pop("batched_mesh")
    meshed = plans.pop("batched_mesh")
    out = dict(runs=runs, candidates=n_cands,
               batched_vs_serial_trials_per_s=bat["trials_per_s"]
               / ser["trials_per_s"],
               decisions_equal_all_fields=plans["serial"].decisions
               == plans["batched"].decisions,
               params_equal=all(torch.equal(a, b) for a, b in zip(
                   tree_leaves(plans["serial"].params),
                   tree_leaves(plans["batched"].params))),
               conv_backward_distinct=conv_backward_repeats(torch))
    print("[sweep] " + json.dumps(out, sort_keys=True), flush=True)
    mesh.update(
        shards=MESH_SHARDS,
        padded_candidates=-(-n_cands // MESH_SHARDS) * MESH_SHARDS,
        decisions_equal_all_fields=meshed.decisions
        == plans["batched"].decisions,
        comp_sha256_equal=mesh["comp_sha256"] == bat["comp_sha256"],
        params_equal=all(torch.equal(a, b) for a, b in zip(
            tree_leaves(meshed.params),
            tree_leaves(plans["batched"].params))),
        vs_unsharded_trials_per_s=mesh["trials_per_s"] / bat["trials_per_s"])
    print("[mesh] sweep " + json.dumps(mesh, sort_keys=True), flush=True)
    if not (mesh["decisions_equal_all_fields"] and mesh["comp_sha256_equal"]
            and mesh["params_equal"]):
        raise AssertionError("[mesh] sweep: the sharded sweep's decisions, "
                             "masks and codebooks or params differ from the "
                             "unsharded sweep's")
    out["mesh"] = mesh
    return out


def conv_backward_repeats(torch, repeats=8):
    """Why `sweep_phase` runs deterministic: the float64 convolution
    backward of a ResNet-20 stage-1 layer at batch BATCH (one kernel, and
    the sweep's 6 candidates as one grouped convolution), repeated on the
    same inputs, under PyTorch's default algorithms and under
    `_Deterministic`. Returns {setting: {shape: distinct input-gradient /
    weight-gradient results in ``repeats`` runs}}; 1 means every run gave
    the same bits."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for setting in ("default", "deterministic"):
        got = {}
        for name, groups in (("16->16 3x3", 1), ("6 x 16->16 3x3", 6)):
            c = 16 * groups
            x = torch.randn((BATCH, c, 32, 32), generator=gen, device="cuda",
                            dtype=torch.float64)
            w = torch.randn((c, 16, 3, 3), generator=gen, device="cuda",
                            dtype=torch.float64)
            g = torch.randn((BATCH, c, 32, 32), generator=gen, device="cuda",
                            dtype=torch.float64)
            seen = {"input": set(), "weight": set()}
            for _ in range(repeats):
                xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
                if setting == "deterministic":
                    with _Deterministic(torch):
                        y = F.conv2d(xr, wr, padding=1, groups=groups)
                        y.backward(g)
                else:
                    y = F.conv2d(xr, wr, padding=1, groups=groups)
                    y.backward(g)
                for key, t in (("input", xr.grad), ("weight", wr.grad)):
                    seen[key].add(hashlib.sha256(
                        t.cpu().numpy().tobytes()).hexdigest())
            got[name] = {k: len(v) for k, v in seen.items()}
            del x, w, g, xr, wr, y
        out[setting] = got
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ LM phase


def lm_config(arch=LM_ARCH):
    """The [lm] phase's config: `reduced_lm_config` of olmo-1b (or
    ``arch``) at its published width and depth (``reduced=False``), no LM
    QAT steps, every matmul restricted to LM_COMPRESS_K values."""
    import dataclasses

    from repro_torch.pipeline.config import reduced_lm_config

    cfg = reduced_lm_config(arch, compress_k=LM_COMPRESS_K)
    return dataclasses.replace(cfg, target=dataclasses.replace(
        cfg.target, reduced=False))


def lm_export_path(torch, arch=LM_ARCH, n_units=None, tag="lm", pipe=None):
    """``Pipeline(lm_config(arch), device="cuda").run_until("export")``
    (or ``pipe``'s: a routed target's pipeline, its plan's parameters
    injected) with every kernel's launches read per stage, then
    `lut_parity_report` over every exported unit; ``n_units`` matmuls
    expected (7 a layer for the dense family). Returns (target, plan,
    [``tag``] metrics)."""
    from repro_torch.core.lm_compress import lut_parity_report
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.kernels.transition_energy import transition_energy as k1
    from repro_torch.pipeline.pipeline import Pipeline

    kernels = {"K1": k1, "K2": k2, "K3": k3}
    if pipe is None:
        pipe = Pipeline(lm_config(arch), device="cuda")
    target = pipe.target
    stages = ("profile", "energy_model", "schedule", "export")
    per_stage = {}
    for stage in stages:
        def counted(plan, cfg, verbose=False, _stage=stage,
                    _fn=getattr(target, f"stage_{stage}")):
            before = {key: mod.launches for key, mod in kernels.items()}
            _fn(plan, cfg, verbose=verbose)
            torch.cuda.synchronize()
            per_stage[_stage] = {key: mod.launches - before[key]
                                 for key, mod in kernels.items()}
        setattr(target, f"stage_{stage}", counted)
    for mod in kernels.values():
        mod.launches = 0
    t0 = time.perf_counter()
    plan = pipe.run_until("export", verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    acfg = target.acfg
    if n_units is None:
        n_units = 7 * acfg.n_layers
    arts = plan.artifacts
    if len(arts) != n_units:
        raise AssertionError(f"[{tag}] exported {len(arts)} matmuls, "
                             f"expected {n_units}")
    t0 = time.perf_counter()
    checked = lut_parity_report(target.model, plan.params, plan.comp, arts,
                                check_units=len(arts))
    parity_s = time.perf_counter() - t0
    parity = max(checked.values())
    if len(checked) != n_units or not parity < LM_PARITY:
        raise AssertionError(f"[{tag}] lut_parity_report: {len(checked)} "
                             f"units, max rel err {parity:.3e} (required < "
                             f"{LM_PARITY})")
    m = plan.metrics
    out = {k: v for k, v in m.items() if k.startswith(("wall_s_", "export_"))}
    out.update(arch=acfg.name, n_params=m["n_params"], n_units=m["n_units"],
               exported_matmuls=len(arts),
               packed_mb=m["export_weight_bytes_packed"] / 1e6,
               energy_per_token=m["energy_per_token"],
               energy_before=m["energy_before"],
               energy_after=m["energy_after"],
               parity_units=len(checked), parity_max_rel_err=parity,
               parity_wall_s=parity_s, export_path_wall_s=wall,
               launches_per_stage=per_stage)
    print(f"[{tag}] {acfg.name}: {m['n_params']:,} params "
          f"({m['n_params'] / 1e9:.3f}e9), {len(arts)} matmuls exported, "
          f"{out['packed_mb']:.1f} MB packed; stages "
          + ", ".join(f"{st} {m[f'wall_s_{st}']:.2f} s" for st in stages)
          + f"; LUT parity over {len(checked)} units max {parity:.2e}",
          flush=True)
    return target, plan, out


def lm_k2_cases(torch, acfg):
    """`k2_phase` cases of the three (K, N) pairs of the LM's matmuls
    (olmo-1b: 2048 x 2048, 2048 x 8192, 8192 x 2048) at prefill (M =
    prompts x prompt length) and decode (M = prompts), the gate's SiLU
    epilogue, each at float32 and at bfloat16 X."""
    d, f = acfg.d_model, acfg.d_ff
    shapes = [("qkvo", d, d, "none"), ("gate", d, f, "silu"),
              ("up", d, f, "none"), ("down", f, d, "none")]
    cases = []
    for step, m in (("prefill", LM_PROMPTS * LM_PROMPT_LEN),
                    ("decode", LM_PROMPTS)):
        for x_dtype, tag in ((torch.float32, ""), (torch.bfloat16, " bf16")):
            for name, k, n, act in shapes:
                cases.append((f"lm {step} {name}{tag}", m, k, k, n, act,
                              False, False, x_dtype, 0, True))
    return cases


def lm_stacked_units(model, params, comp, top="blocks"):
    """(names, weights, comps) of every unit of the model's stacked blocks
    (or of its unstacked ``tail``; ``top`` a tuple: of several, such as
    ("blocks", "enc_blocks"), whose encoder block holds its units
    directly): the entries of one grouped K3 launch of a fake-quant
    forward."""
    from repro_torch.nn.transformer import block_matmuls

    names, ws, comps = [], [], []
    for t in (top,) if isinstance(top, str) else top:
        groups = {None: params[t]} if t == "enc_blocks" else params[t]
        for g, block in groups.items():
            node = comp[t] if g is None else comp[t][g]
            for unit in block_matmuls(block):
                sub, key = unit.split("/")
                names.append(f"{t}/{unit}" if g is None
                             else f"{t}/{g}/{unit}")
                ws.append(block[sub][key])
                comps.append({k: v for k, v in node[unit].items()
                              if k != "serve"})
    return names, ws, comps


def lm_k3_phase(torch, model, params, comp, top="blocks", tag="lm-k3"):
    """K3 on the stacked units of the LM, as a fake-quant forward calls it:
    one launch of 7 entries x L candidates (the layer axis), held against
    its plain version bit for bit; one call timed between CUDA events (a
    launch of milliseconds: the host's share drops out) beside its bound
    and the plain version. ``top="tail"``: the launch of the unstacked
    tail's units (no candidate axis). The launches here are not the main
    path's."""
    from repro_torch.core import qat
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.fake_quant import ref

    names, ws, comps = lm_stacked_units(model, params, comp, top)
    n = None if top == "tail" else model.n_rep
    launched = k3.launches
    with torch.no_grad():
        got = qat.fake_quant_weights(ws, comps, cands=n)
        if k3.launches - launched != 1:
            raise AssertionError(f"[{tag}] {k3.launches - launched} "
                                 "launches, expected 1")
        torch.cuda.synchronize()
        max_err = 0.0
        for i, (w, c) in enumerate(zip(ws, comps)):
            want = ref.fake_quant_group_ref([w], [c], n)[0]
            max_err = max(max_err, float((got[i] - want).abs().max()))
            if not equal_nan(torch, got[i], want):
                raise AssertionError(
                    f"[{tag}] {names[i]} {tuple(w.shape)}: kernel differs "
                    f"from the plain version (max abs err {max_err:.3e}; "
                    "required: equal)")
            del want
        del got
        ms = time_turns(torch, {
            "kernel": lambda: qat.fake_quant_weights(ws, comps, cands=n),
            "plain": lambda: ref.fake_quant_group_ref(ws, comps, n)}, 3)
    k3.launches = launched
    bound_ms, bound_by = k3_bound(ws, comps)
    out = dict(entries=len(ws), candidates=n,
               weights=sum(w.numel() for w in ws), max_abs_err=max_err,
               device_ms=ms["kernel"], plain_ms=ms["plain"],
               timing="cuda events, one call", bound_ms=bound_ms,
               bound_by=bound_by,
               shapes=[[nm, list(w.shape)] for nm, w in zip(names, ws)])
    print(f"[{tag}] one launch of {len(ws)} entries x {n} candidates "
          f"({out['weights']:,} weights): equal to the plain version; "
          f"{ms['kernel']:.3f} ms (events), plain {ms['plain']:.1f} ms, "
          f"bound {bound_ms:.3f} ms ({bound_by})", flush=True)
    return out


def lm_rel(torch, a, b, vocab):
    a, b = a[..., :vocab].double(), b[..., :vocab].double()
    return float(torch.linalg.norm(a - b)
                 / torch.clamp(torch.linalg.norm(b), min=1e-9))


def lm_generate(torch, model, params, comp, qcfg, prompts, cache_dtype,
                feed=None, enc_embeds=None, max_len=LM_MAX_LEN,
                prefix_embeds=None):
    """Prefill ``prompts`` (B, S) to ``max_len`` (with ``enc_embeds``: the
    encoder-decoder family's frames; with ``prefix_embeds``: a VLM's patch
    embeddings in front of the prompt), then LM_DECODE_STEPS decode steps:
    greedy from this run's own logits, or fed the tokens ``feed`` (B,
    steps) so two runs see the same inputs. Returns
    (prefill logits, [decode logits], fed tokens (B, steps), prefill s,
    [decode s], {kernel: launches} of the prefill, [of each step])."""
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import lut_matmul as k2

    def counts():
        return {"K2": k2.launches, "K3": k3.launches}

    def since(before):
        return {k: v - before[k] for k, v in counts().items()}

    vocab = model.cfg.vocab
    with torch.no_grad():
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompts, max_len, qcfg=qcfg,
                                      comp=comp, cache_dtype=cache_dtype,
                                      enc_embeds=enc_embeds,
                                      prefix_embeds=prefix_embeds)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = since(before)
        tok = logits[:, -1:, :vocab].argmax(-1).to(torch.int32)
        step_logits, step_s, step_launches, fed = [], [], [], []
        for i in range(LM_DECODE_STEPS):
            if feed is not None:
                tok = feed[:, i:i + 1]
            fed.append(tok)
            before = counts()
            t0 = time.perf_counter()
            out, cache = model.decode_step(params, cache, tok, qcfg=qcfg,
                                           comp=comp)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            step_launches.append(since(before))
            step_logits.append(out)
            tok = out[:, :, :vocab].argmax(-1).to(torch.int32)
    return (logits, step_logits, torch.cat(fed, dim=1), prefill_s, step_s,
            prefill_launches, step_launches)


def lm_dequantized_units(torch, model, params, arts):
    """{"blocks": {g: {unit: (L, ...)}}, "tail": {t: {unit: ...}},
    "enc_blocks": {unit: (L_enc, ...)}}: every unit's weight as its
    exported artifacts serve it (each layer's, or each (layer, expert)'s,
    artifact dequantized, laid out as the parameter), in the form of
    `LMModel._fake_quant_units`."""
    from repro_torch.core.lm_compress import MOE_EXPERT_KEYS
    from repro_torch.kernels.lut_matmul import ref
    from repro_torch.nn.transformer import block_matmuls

    tops = {top: ({None: params[top]} if top == "enc_blocks"
                  else params[top])
            for top in ("blocks", "tail", "enc_blocks") if top in params}
    out = {"blocks": {}, "tail": {}, "enc_blocks": {}}
    for top, groups in tops.items():
        for g, block in groups.items():
            node = out[top] if g is None else out[top].setdefault(g, {})
            base = top if g is None else f"{top}/{g}"
            for unit in block_matmuls(block):
                sub, key = unit.split("/")
                w = block[sub][key]
                slices = [f"{base}/{unit}[{j}]" for j in range(w.shape[0])] \
                    if top != "tail" else [f"{base}/{unit}"]
                if sub == "moe" and key in MOE_EXPERT_KEYS:
                    n_exp = w.shape[1 if top != "tail" else 0]
                    slices = [f"{name}[e{e}]" for name in slices
                              for e in range(n_exp)]
                node[unit] = torch.stack([
                    ref.dequantize(a.packed, a.codebook, a.scale,
                                   a.block_k)[:a.k_dim]
                    for a in (arts[name] for name in slices)
                ]).reshape(w.shape).to(w.dtype)
    return out


def lm_witness(torch, model, plan, prompts, dtype, feed, served,
               enc_embeds=None, max_len=LM_MAX_LEN, prefix_embeds=None):
    """The fake-quant forward with each weight set to its artifact's
    dequantized weight (`lm_dequantized_units`) in place of K3's
    straight-through value: on the same products and activation rounding
    as the served path, it tells the served path's plumbing (layer slices
    of the stacked artifacts, layouts, dtypes) from the straight-through
    rounding. Returns its logits' rel err against the served run's, and
    how far K3's straight-through weights are from the artifacts'."""
    from repro_torch.core.lm_compress import _unit_nodes
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.nn.layers import QuantConfig

    deq = lm_dequantized_units(torch, model, plan.params, plan.artifacts)
    launched = k3.launches
    with torch.no_grad():
        st = model._fake_quant_units(plan.params, plan.comp,
                                     QuantConfig.on())
    k3.launches = launched
    differ = total = 0
    max_diff = 0.0
    for top, g, units in _unit_nodes(deq):
        node = st[top] if g is None else st[top][g]
        for unit, w in units.items():
            d = (node[unit] - w).abs()
            differ += int((d != 0).sum())
            total += d.numel()
            max_diff = max(max_diff, float(d.max()))
    del st
    model._fake_quant_units = lambda params, comp, qcfg: deq
    try:
        run = lm_generate(torch, model, plan.params, plan.comp,
                          QuantConfig.on(), prompts, dtype, feed,
                          enc_embeds, max_len, prefix_embeds)
    finally:
        del model._fake_quant_units
    vocab = model.cfg.vocab
    return dict(
        prefill_logit_rel_err=lm_rel(torch, run[0], served[0], vocab),
        decode_logit_rel_err=[lm_rel(torch, a, b, vocab)
                              for a, b in zip(run[1], served[1])],
        launches_prefill=run[5],
        straight_through_weights_differing=differ / total,
        straight_through_max_abs_diff=max_diff)


def lm_serve_phase(torch, target, plan, comp_serve, compute_dtype,
                   tag="lm-serve", shared_codes=False, own_code_gate=True):
    """Served (`QuantConfig.serve`, K2) against fake-quant
    (`QuantConfig.on()`, K3) prefill and decode at ``compute_dtype``:
    LM_PROMPTS seeded prompts of LM_PROMPT_LEN tokens, then LM_DECODE_STEPS
    greedy steps of the served model, the fake-quant model fed the same
    tokens. Each path runs once to warm up, then timed; the served warm-up
    records the dtype of each K2 launch's x. Launches: a served prefill or
    decode step one K2 launch an exported matmul (7 a dense layer) and no
    K3, a fake-quant one one K3 launch (one more for a tail of unstacked
    blocks) and no K2. At float32 it runs `lm_witness` too. Returns the
    metrics; raises at float32 if the prefill logits differ by 2e-2 or
    more (the README's ``serve_forward_parity``), or the witness's differ
    from the served ones by WITNESS_PARITY or more. ``shared_codes``: the
    witness and the fake-quant forward run again on the served run's int8
    activation codes (`_ActQuant` replay, as `encdec_serve`), with the
    codes their own rounding would flip counted, and both are gated at
    WITNESS_PARITY; the witness on its own codes is reported (queue 3's
    rule: the straight-through weight differs from the artifact's by
    float32 ulps, which can move a code that sits at a rounding
    boundary, and a deep model at random init carries a few such moves to
    the logits). ``own_code_gate=False`` (with ``shared_codes``): the
    served-vs-fake-quant logits on each run's own codes are reported, not
    gated at 2e-2; the shared-code gates stand in for them."""
    import dataclasses

    from repro_torch.core import export
    from repro_torch.models.lm import build_lm
    from repro_torch.nn.layers import QuantConfig

    acfg = dataclasses.replace(target.acfg, compute_dtype=compute_dtype)
    model = build_lm(acfg)
    dtype = acfg.cdtype
    gen = torch.Generator(device="cuda").manual_seed(LM_PROMPT_SEED)
    prompts = torch.randint(0, acfg.vocab, (LM_PROMPTS, LM_PROMPT_LEN),
                            generator=gen, device="cuda", dtype=torch.int32)
    params = plan.params
    n_units = len(plan.artifacts)
    k3_per_forward = sum(top in params for top in ("blocks", "tail"))
    real_k2 = export.lut_matmul_fused
    x_dtypes = []

    def recording(x, packed, *a, **kw):
        x_dtypes.append([str(x.dtype).replace("torch.", ""),
                         x.shape[1], packed.shape[1]])
        return real_k2(x, packed, *a, **kw)

    runs = {}
    feed = None
    for label, qcfg, comp in (("served", QuantConfig.serve(), comp_serve),
                              ("fake_quant", QuantConfig.on(), plan.comp)):
        if label == "served":
            export.lut_matmul_fused = recording
        try:
            lm_generate(torch, model, params, comp, qcfg, prompts, dtype,
                        feed)
        finally:
            export.lut_matmul_fused = real_k2
        runs[label] = lm_generate(torch, model, params, comp, qcfg, prompts,
                                  dtype, feed)
        feed = runs[label][2]
        torch.cuda.empty_cache()
    # the served warm-up's K2 calls: a prefill's n_units, then each step's
    k2_x = {"prefill": x_dtypes[:n_units],
            "decode_step": x_dtypes[n_units:2 * n_units]}
    want = {"served": {"K2": n_units, "K3": 0},
            "fake_quant": {"K2": 0, "K3": k3_per_forward}}
    for label, run in runs.items():
        for where, got in [("prefill", run[5])] + [
                (f"decode step {i}", c) for i, c in enumerate(run[6])]:
            if got != want[label]:
                raise AssertionError(f"[{tag}] {compute_dtype} {label} "
                                     f"{where}: launches {got}, expected "
                                     f"{want[label]}")
    srv, fq = runs["served"], runs["fake_quant"]
    for label, run in runs.items():
        shape = (LM_PROMPTS, LM_PROMPT_LEN, acfg.padded_vocab)
        if tuple(run[0].shape) != shape or not torch.isfinite(
                run[0][..., :acfg.vocab]).all():
            raise AssertionError(f"[{tag}] {label}: bad prefill logits "
                                 f"{tuple(run[0].shape)}")
    vocab = acfg.vocab
    prefill_rel = lm_rel(torch, srv[0], fq[0], vocab)
    step_rel = [lm_rel(torch, a, b, vocab) for a, b in zip(srv[1], fq[1])]
    agree = [float((a[..., :vocab].argmax(-1) == b[..., :vocab].argmax(-1))
                   .float().mean()) for a, b in zip(srv[1], fq[1])]
    out = dict(compute_dtype=compute_dtype, prompts=LM_PROMPTS,
               prompt_len=LM_PROMPT_LEN, max_len=LM_MAX_LEN,
               decode_steps=LM_DECODE_STEPS,
               prefill_logit_rel_err=prefill_rel,
               decode_logit_rel_err=step_rel,
               greedy_token_agreement=agree,
               greedy_token_agreement_mean=sum(agree) / len(agree),
               launches_prefill={k: r[5] for k, r in runs.items()},
               launches_decode_step={k: r[6][0] for k, r in runs.items()},
               k2_x_dtype_counts={
                   step: {dt: sum(c[0] == dt for c in calls)
                          for dt in sorted({c[0] for c in calls})}
                   for step, calls in k2_x.items()},
               k2_x_dtype_calls={
                   step: [[i, *c] for i, c in enumerate(calls)
                          if c[0] != "float32"]
                   for step, calls in k2_x.items()})
    if compute_dtype == "float32":
        out["witness"] = lm_witness(torch, model, plan, prompts, dtype,
                                    srv[2], srv)
    if compute_dtype == "float32" and shared_codes:
        with _ActQuant(device="cuda") as record:
            lm_generate(torch, model, params, comp_serve,
                        QuantConfig.serve(), prompts, dtype, srv[2])
        with _ActQuant(replay=record) as replayed:
            shared = lm_witness(torch, model, plan, prompts, dtype, srv[2],
                                srv)
        codes = sum(c.numel() for c in record.codes)
        out["witness_on_served_codes"] = dict(
            shared, flipped_codes=replayed.flips, codes=codes)
        with _ActQuant(replay=record) as replayed:
            fq_shared = lm_generate(torch, model, params, plan.comp,
                                    QuantConfig.on(), prompts, dtype, srv[2])
        out["fake_quant_on_served_codes"] = dict(
            prefill_logit_rel_err=lm_rel(torch, srv[0], fq_shared[0], vocab),
            decode_logit_rel_err=[lm_rel(torch, a, b, vocab)
                                  for a, b in zip(srv[1], fq_shared[1])],
            flipped_codes=replayed.flips, codes=codes)
        del record, fq_shared
        torch.cuda.empty_cache()
    for label, run in runs.items():
        out[f"{label}_prefill_s"] = run[3]
        out[f"{label}_prefill_tokens_per_s"] = (LM_PROMPTS * LM_PROMPT_LEN
                                                / run[3])
        out[f"{label}_decode_ms_per_step"] = [1e3 * t for t in run[4]]
        out[f"{label}_decode_ms_per_step_median"] = 1e3 * statistics.median(
            run[4])
    print(f"[{tag}] " + json.dumps(out, sort_keys=True), flush=True)
    if (compute_dtype == "float32" and own_code_gate
            and not prefill_rel < SERVE_PARITY):
        raise AssertionError(f"[{tag}] float32 prefill logit rel err "
                             f"{prefill_rel:.3e} >= {SERVE_PARITY}")
    gated = ["witness"] if "witness" in out else []
    if "witness_on_served_codes" in out:
        gated = ["witness_on_served_codes", "fake_quant_on_served_codes"]
    for key in gated:
        wit = out[key]
        worst = max([wit["prefill_logit_rel_err"]]
                    + wit["decode_logit_rel_err"])
        if not worst < WITNESS_PARITY:
            raise AssertionError(f"[{tag}] {key} vs served logit rel "
                                 f"err {worst:.3e} >= {WITNESS_PARITY}")
    del runs, srv, fq
    torch.cuda.empty_cache()
    return out


def lm_k2_replays(torch):
    """`breakdown` replays of K2's recorded calls through its plain version
    (``k2_plain``) and through `torch.matmul` on the call's dequantized
    weight, its epilogue in torch (``k2_library``)."""
    from repro_torch.kernels.lut_matmul import ref

    def plain(a, kw):
        x, packed, codebook, scale = a
        return lambda: ref.lut_matmul_fused_ref(
            x, packed, codebook, scale, bias=kw.get("bias"),
            residual=kw.get("residual"),
            activation=kw.get("activation", "none"),
            block_k=kw["pack_block"])

    def library(a, kw):
        x, packed, codebook, scale = a
        w = ref.weight_rows(ref.dequantize(packed, codebook, scale,
                                           kw["pack_block"]), x.shape[1])
        act = ref.ACTIVATIONS[kw.get("activation", "none")]
        bias, res = kw.get("bias"), kw.get("residual")

        def run():
            y = torch.matmul(x.float(), w)
            if bias is not None:
                y = y + bias
            y = act(y)
            return y if res is None else y + res
        return run

    return {"k2_plain": ("k2", plain), "k2_library": ("k2", library)}


def lm_k2_step(ms, k2_calls):
    """K2 over one step's recorded calls: the replays' ms (kernel, plain
    version, `torch.matmul`), and `bound` summed over the calls."""
    bounds = []
    for (x, packed, codebook, scale), kw in k2_calls:
        case = dict(x=x, packed=packed, codebook=codebook,
                    bias=kw.get("bias"), residual=kw.get("residual"))
        bounds.append(bound(x.shape[0], x.shape[1], scale.numel(), case))
    total = sum(b for b, _ in bounds)
    by_bytes = sum(b for b, by in bounds if by == "bytes")
    return dict(calls=len(k2_calls), ms=ms["k2"], plain_ms=ms["k2_plain"],
                library_ms=ms["k2_library"], bound_ms=total,
                bound_by="bytes" if by_bytes >= total / 2 else "operations",
                timing="the step's recorded calls replayed back to back "
                       "between CUDA events")


def lm_breakdown(torch, target, plan, comp_serve):
    """Where a served float32 prefill's and decode step's time goes: the
    step, and the calls it made of K2, attention (blocked and decode),
    RoPE, layer norms, activation fake-quant and the unembedding, each
    replayed alone (`breakdown`); K2's calls replayed through its plain
    version and `torch.matmul` too (``k2_step``, `lm_k2_step`)."""
    import dataclasses

    from repro_torch.core import export, qat
    from repro_torch.models.lm import build_lm
    from repro_torch.nn import attention, transformer
    from repro_torch.nn.layers import QuantConfig

    model = build_lm(dataclasses.replace(target.acfg,
                                         compute_dtype="float32"))
    gen = torch.Generator(device="cuda").manual_seed(LM_PROMPT_SEED)
    prompts = torch.randint(0, model.cfg.vocab, (LM_PROMPTS, LM_PROMPT_LEN),
                            generator=gen, device="cuda", dtype=torch.int32)
    qserve = QuantConfig.serve()
    targets = {"k2": (export, "lut_matmul_fused"),
               "attention": (attention, "blocked_attention"),
               "decode_attention": (attention, "decode_attention"),
               "rope": (attention, "apply_rope"),
               "norms": (transformer, "apply_layernorm"),
               "fake_quant_acts": (qat, "fake_quant_act"),
               "unembed": (model, "_unembed")}
    replays = lm_k2_replays(torch)
    parts = {}
    with torch.no_grad():
        _, cache = model.prefill(plan.params, prompts, LM_MAX_LEN,
                                 qcfg=qserve, comp=comp_serve,
                                 cache_dtype=torch.float32)
        tok = prompts[:, -1:]
        for step, forward in (
                ("prefill", lambda: model.prefill(
                    plan.params, prompts, LM_MAX_LEN, qcfg=qserve,
                    comp=comp_serve, cache_dtype=torch.float32)),
                ("decode_step", lambda: model.decode_step(
                    plan.params, cache, tok, qcfg=qserve,
                    comp=comp_serve))):
            ms, calls = breakdown(torch, forward, targets, 5, replays)
            ms["k2_step"] = lm_k2_step(ms, calls["k2"])
            parts[step] = ms
            del calls
            torch.cuda.empty_cache()
    for ms in parts.values():
        ms["other"] = ms["forward"] - sum(
            v for k, v in ms.items()
            if k not in ("forward", "calls", "k2_step") + tuple(replays))
    print("[lm-breakdown] " + json.dumps(parts, sort_keys=True), flush=True)
    return parts


def counting_calls(model, names=("prefill", "prefill_chunk",
                                   "decode_step")):
    """{name: calls} of the model's forward entry points, counted from now
    on (the engine's step builds call them through the model object)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*a, _name=name, _real=getattr(model, name), **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        setattr(model, name, counted)
    return calls


def serve_numbers(rep):
    """The engine report's end-to-end numbers."""
    keys = ("requests", "new_tokens", "wall_s", "tokens_per_s",
            "ttft_p50_s", "ttft_p99_s", "latency_p50_s", "latency_p99_s",
            "slot_utilization", "executed_positions", "energy_eu_overhead",
            "cache_compile_count", "cache_buckets_compiled")
    return {k: rep[k] for k in keys if k in rep}


def lm_engine_stage(torch, plan, arch=LM_ARCH, tag="[lm-engine] (a)"):
    """(a) The normal entry point: ``Pipeline.from_plan(plan, device=
    "cuda")`` through ``serve`` on the [lm] plan (or ``arch``'s; the
    fake-quant engine, then the oneshot fallback: `LMTarget.stage_serve`),
    every forward call counted, peak memory read. Gates: engine ==
    oneshot, no build after warmup, one K3 launch a forward call (one a
    forward and stacked/tail group of blocks) and no K2. Returns (metrics,
    the target)."""
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.pipeline.pipeline import Pipeline

    cfg = lm_config(arch).with_overrides({"serve": LM_STAGE_SERVE})
    pipe = Pipeline.from_plan(plan, cfg=cfg, device="cuda")
    calls = counting_calls(pipe.target.model)
    per_forward = sum(top in plan.params for top in ("blocks", "tail"))
    k2.launches = k3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe.run_until("serve", verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {"K2": k2.launches, "K3": k3.launches}
    for name in calls:
        pipe.target.model.__dict__.pop(name, None)
    m = plan.metrics
    forwards = sum(calls.values())
    out = dict(serve=LM_STAGE_SERVE, stage_wall_s=wall, peak_mem_gb=peak,
               forward_calls=dict(calls),
               launches=launches,
               parity_engine_vs_oneshot=m["serve_parity_engine_vs_oneshot"],
               recompiles_after_warmup=m["serve_recompiles_after_warmup"],
               **{k[len("serve_"):]: v for k, v in m.items()
                  if k.startswith("serve_") and k[len("serve_"):] in (
                      "requests", "new_tokens", "wall_s", "tokens_per_s",
                      "ttft_p50_s", "ttft_p99_s", "latency_p50_s",
                      "latency_p99_s", "slot_utilization",
                      "executed_positions")})
    print(f"{tag} " + json.dumps(out, sort_keys=True), flush=True)
    if out["parity_engine_vs_oneshot"] is not True:
        raise AssertionError(f"{tag} engine tokens != oneshot tokens")
    if out["recompiles_after_warmup"] != 0:
        raise AssertionError(f"{tag} {out['recompiles_after_warmup']}"
                             " builds after warmup")
    if launches != {"K2": 0, "K3": per_forward * forwards}:
        raise AssertionError(f"{tag} launches {launches}, expected "
                             f"{per_forward} K3 launch(es) a forward call "
                             f"({forwards}) and no K2")
    return out, pipe.target


def lm_engine_split(torch, engine):
    """Where one group decode step and one 4-row chunk step of the LUT
    engine spend their time (`breakdown`: each part's calls replayed alone
    between CUDA events): K2, attention, activation fake-quant, RoPE, norms,
    the cache merge (decode) or row gather/scatter (chunk), the
    unembedding, and ``other`` (the step less the parts)."""
    from repro_torch.core import export, qat
    from repro_torch.nn import attention, transformer

    model, params, cfg = engine.model, engine.params, engine.config
    group = engine.cache.group_fns(params)
    chunk = engine.cache.chunk_fns(LM_LUT_ENGINE["prompt_buckets"][0], 4,
                                   params)
    dev = engine.device
    cache = group.make_cache()
    batch = cfg.max_batch
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    active = torch.ones((batch,), dtype=torch.bool, device=dev)
    toks = torch.zeros((4, chunk.chunk), dtype=torch.int32, device=dev)
    rows = torch.arange(4, dtype=torch.int32, device=dev)
    start = torch.full((4,), chunk.chunk, dtype=torch.int32, device=dev)
    common = {"k2": (export, "lut_matmul_fused"),
              "fake_quant_acts": (qat, "fake_quant_act"),
              "rope": (attention, "apply_rope"),
              "norms": (transformer, "apply_layernorm"),
              "unembed": (model, "_unembed")}
    parts = {}
    for step, forward, extra in (
            ("decode_step", lambda: group.decode(params, cache, tok, active),
             {"attention": (attention, "decode_attention"),
              "cache_merge": (model, "_merge_active")}),
            ("chunk_step_4_rows", lambda: chunk.fn(params, cache, toks, rows,
                                                   start, active[:4]),
             {"attention": (attention, "blocked_attention"),
              "cache_gather": (model, "gather_cache_rows"),
              "cache_scatter": (model, "scatter_cache_rows")})):
        ms, _ = breakdown(torch, forward, {**common, **extra}, 5)
        ms["other"] = ms["forward"] - sum(v for k, v in ms.items()
                                          if k not in ("forward", "calls"))
        parts[step] = ms
        torch.cuda.empty_cache()
    for attr in ("_unembed", "_merge_active", "gather_cache_rows",
                 "scatter_cache_rows"):
        model.__dict__.pop(attr, None)
    print("[lm-engine-breakdown] " + json.dumps(parts, sort_keys=True),
          flush=True)
    return parts


def tree_sum(torch, x, dim=-1):
    """The sum over ``dim`` in float32 by pairwise halving (zero-padded to
    a power of two): its order is fixed by the axis length alone, whatever
    the other axes hold."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    width = 1 << (n - 1).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def sum_variants(torch):
    """{variant: {(module, attribute): stand-in}}: the row sums of the
    engine's batch-invariant forward as shipped ("float64": summed in
    float64, rounded once), in a fixed float32 order ("fixed32": pairwise
    halving, `tree_sum`, products as elementwise products summed so; the
    unembedding stays float64, since its product tensor would hold M x d x
    vocab floats), and in PyTorch's own float32 order ("float32": the JAX
    package's sums). Each stand-in replaces the ``exact`` branch of the
    attention products and softmax sums (`attention._scores`,
    `attention._row_sum`) and of the layer norm; activation scales stay
    one a token position in every variant."""
    from repro_torch.models import lm
    from repro_torch.nn import attention, transformer

    scores, row_sum = attention._scores, attention._row_sum
    layernorm = transformer.apply_layernorm

    def tree_mm(a, b):
        return tree_sum(torch, a.float().unsqueeze(-1)
                        * b.float().unsqueeze(-3), -2)

    def layernorm_fixed(params, x, *, eps=1e-5, exact=False):
        if not exact:
            return layernorm(params, x, eps=eps)
        xf = x.float()
        mean = (tree_sum(torch, xf) / xf.shape[-1])[..., None]
        var = (tree_sum(torch, (xf - mean) ** 2) / xf.shape[-1])[..., None]
        y = (xf - mean) * torch.rsqrt(var + eps)
        if params:
            y = y * params["scale"].float() + params["bias"].float()
        return y.to(x.dtype)

    return {
        "float64": {},
        "fixed32": {
            (attention, "_scores"): lambda a, b, exact: (
                tree_mm(a, b) if exact else scores(a, b, False)),
            (attention, "_row_sum"): lambda x, exact: (
                tree_sum(torch, x) if exact else row_sum(x, False)),
            (transformer, "apply_layernorm"): layernorm_fixed},
        "float32": {
            (attention, "_scores"): lambda a, b, exact: scores(a, b, False),
            (attention, "_row_sum"): lambda x, exact: row_sum(x, False),
            (transformer, "apply_layernorm"):
                lambda params, x, *, eps=1e-5, exact=False: layernorm(
                    params, x, eps=eps),
            (lm, "exact_matmul"): lambda a, b: torch.matmul(a, b)},
    }


def rows_alone(torch, engine):
    """How many rows of a group decode step (``max_batch`` rows) and of a
    4-row chunk step get, bit for bit, the logits each gets alone: the
    model's forwards with the engine's qcfg and comp, on a group cache
    filled by one chunk of seeded tokens."""
    model, params, cfg = engine.model, engine.params, engine.config
    kw = dict(qcfg=engine.qcfg, comp=engine.comp)
    chunk_kw = dict(kw, q_block=cfg.q_block, kv_block=cfg.kv_block)
    batch, chunk = cfg.max_batch, cfg.prompt_buckets[0]
    dev = engine.device
    gen = torch.Generator(device=dev).manual_seed(LM_LUT_PROMPT_SEED)

    def draw(rows, n):
        return torch.randint(0, model.cfg.vocab, (rows, n), generator=gen,
                             device=dev, dtype=torch.int32)

    def rows_of(cache, rows):
        return model.gather_cache_rows(cache, torch.tensor(
            rows, dtype=torch.int32, device=dev))

    start = torch.zeros(batch, dtype=torch.int32, device=dev)
    with torch.no_grad():
        cache = model.init_cache(batch, cfg.group_total_len,
                                 cfg.torch_cache_dtype, device=dev)
        _, cache = model.prefill_chunk(params, cache, draw(batch, chunk),
                                       start=start, **chunk_kw)
        toks, tok = draw(4, chunk), draw(batch, 1)
        both = model.prefill_chunk(params, rows_of(cache, [0, 1, 2, 3]),
                                   toks, start=start[:4] + chunk,
                                   **chunk_kw)[0]
        chunk_equal = sum(torch.equal(both[r:r + 1], model.prefill_chunk(
            params, rows_of(cache, [r]), toks[r:r + 1],
            start=start[:1] + chunk, **chunk_kw)[0]) for r in range(4))
        both = model.decode_step(params, cache, tok, **kw)[0]
        decode_equal = sum(torch.equal(both[r:r + 1], model.decode_step(
            params, rows_of(cache, [r]), tok[r:r + 1], **kw)[0])
            for r in range(batch))
    return {"decode_rows_equal": f"{decode_equal}/{batch}",
            "chunk_rows_equal": f"{chunk_equal}/4",
            "row_invariant": decode_equal == batch and chunk_equal == 4}


def step_ms(torch, engine):
    """Median ms of one group decode step and one 4-row chunk step of the
    engine's built steps (CUDA events, `time_turns`)."""
    params, cfg, dev = engine.params, engine.config, engine.device
    group = engine.cache.group_fns(params)
    chunk = engine.cache.chunk_fns(cfg.prompt_buckets[0], 4, params)
    cache = group.make_cache()
    tok = torch.zeros((cfg.max_batch, 1), dtype=torch.int32, device=dev)
    active = torch.ones((cfg.max_batch,), dtype=torch.bool, device=dev)
    toks = torch.zeros((4, chunk.chunk), dtype=torch.int32, device=dev)
    rows = torch.arange(4, dtype=torch.int32, device=dev)
    start = torch.full((4,), chunk.chunk, dtype=torch.int32, device=dev)
    with torch.no_grad():
        return time_turns(torch, {
            "decode_step_ms": lambda: group.decode(params, cache, tok,
                                                   active),
            "chunk_step_4_rows_ms": lambda: chunk.fn(params, cache, toks,
                                                     rows, start,
                                                     active[:4])}, 5)


def lm_engine_sums(torch, model, params, handle, cfg, shapes, requests,
                   want, device="cuda"):
    """What the engine's float64 sums cost and what a fixed float32 order
    would (`sum_variants`): for each variant, the LUT engine in engine
    mode over (b)'s trace (tokens/s, the share of greedy tokens equal to
    (b)'s engine run ``want``), a group decode step's and a 4-row chunk
    step's ms, and whether a batched step's rows equal the rows run alone
    (`rows_alone`). Gate: the shipped variant's rows do."""
    from repro_torch.serving import ServingEngine

    out = {}
    for name, patches in sum_variants(torch).items():
        real = {key: getattr(*key) for key in patches}
        for (mod, attr), fn in patches.items():
            setattr(mod, attr, fn)
        try:
            engine = ServingEngine(model, params, config=cfg, plan=handle,
                                   device=device)
            engine.warmup(shapes)
            got = [r.tokens for r in engine.serve(requests)]
            rep = engine.report()
            out[name] = dict(rows_alone(torch, engine), **step_ms(
                torch, engine), tokens_per_s=rep["tokens_per_s"])
        finally:
            for (mod, attr), fn in real.items():
                setattr(mod, attr, fn)
        pairs = [(a, b) for x, y in zip(got, want) for a, b in zip(x, y)]
        out[name]["tokens_equal_to_engine"] = sum(
            a == b for a, b in pairs) / len(pairs)
        del engine
        torch.cuda.empty_cache()
    print("[lm-engine-sums] " + json.dumps(out, sort_keys=True), flush=True)
    if not out["float64"]["row_invariant"]:
        raise AssertionError("[lm-engine-sums] the engine's float64 sums: "
                             "a batched step's rows differ from the rows "
                             f"run alone: {out['float64']}")
    return out


def lm_engine_lut(torch, target, plan):
    """(b) The packed-LUT engine built directly (``lut_serve=True``: the
    stage never sets it), on a float32 olmo-1b cut to its first
    LM_ENGINE_LAYERS layers, over the [lm] plan's parameters and comp tree
    of those layers: LM_LUT_REQUESTS requests of the mixed trace
    (`lm_trace_shapes`), seeded numpy prompts, served in each mode. Gates:
    greedy tokens equal across the modes, no build after warmup, 7 K2
    launches a layer a forward call (prefill, chunk step or decode step) and no
    K3. Every engine has ``autotune_cache``: the first saves K2's tuner
    cache after its warmup; then a restart (the process-wide tuner dropped)
    builds an engine-mode engine that loads it and warms up with 0
    retunes. Then the step split (`lm_engine_split`) and what the engine's
    float64 sums cost against the alternatives (`lm_engine_sums`)."""
    import dataclasses

    from repro_torch._device import tree_map
    from repro_torch.distributed.sharding import request_mesh
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import autotune as at
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.models.lm import build_lm
    from repro_torch.pipeline.targets import lm_trace_shapes
    from repro_torch.serving import (
        EngineConfig,
        PlanHandle,
        ServeRequest,
        ServingEngine,
    )

    layers = min(LM_ENGINE_LAYERS, target.acfg.n_layers)
    model = build_lm(dataclasses.replace(target.acfg, n_layers=layers,
                                         compute_dtype="float32"))
    params, comp = (dict(t, blocks=tree_map(lambda x: x[:layers],
                                            t["blocks"]))
                    for t in (plan.params, plan.comp))
    n_units = 7 * model.cfg.n_layers
    tune_cache = ROOT / "build" / "chip_smoke" / "lm_engine_autotune.json"
    tune_cache.unlink(missing_ok=True)
    cfg = EngineConfig(**LM_LUT_ENGINE, autotune_cache=str(tune_cache))
    handle = PlanHandle.from_comp(comp, compress_k=LM_COMPRESS_K,
                                  plan_id=f"k{LM_COMPRESS_K}")
    shapes = lm_trace_shapes(LM_LUT_REQUESTS, LM_LUT_PROMPT_LEN,
                             LM_LUT_NEW_TOKENS, True)
    requests = [ServeRequest(
        tokens=np.random.default_rng(LM_LUT_PROMPT_SEED + i).integers(
            0, model.cfg.vocab, plen).astype(np.int32), max_new_tokens=ntok)
        for i, (plen, ntok) in enumerate(shapes)]
    runs, tokens, logits = {}, {}, {}
    split = None
    mesh = card_mesh(torch, request_mesh, MESH_REQUEST_SHARDS)
    for mode in ("engine", "wave", "oneshot", "wave_mesh"):
        calls = counting_calls(model)
        k2.launches = k3.launches = 0
        t0 = time.perf_counter()
        engine = ServingEngine(model, params, mode=mode.split("_")[0],
                               config=cfg, plan=handle, device="cuda",
                               mesh=mesh if mode == "wave_mesh" else None)
        if mode.startswith("wave"):
            logits[mode] = recording_host(engine)
        engine.warmup(shapes)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_builds = engine.cache.compile_count
        torch.cuda.reset_peak_memory_stats()
        results = engine.serve(requests)
        torch.cuda.synchronize()
        rep = engine.report()
        launches = {"K2": k2.launches, "K3": k3.launches}
        forwards = sum(calls.values())
        tokens[mode] = [r.tokens for r in results]
        runs[mode] = dict(serve_numbers(rep), warmup_s=warm_s,
                          builds=warm_builds,
                          builds_after_warmup=engine.cache.compile_count
                          - warm_builds,
                          forward_calls=dict(calls), launches=launches,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        if launches != {"K2": n_units * forwards, "K3": 0}:
            raise AssertionError(f"[lm-engine] (b) {mode}: launches "
                                 f"{launches}, expected {n_units} K2 a "
                                 f"forward call ({forwards}) and no K3")
        if runs[mode]["builds_after_warmup"]:
            raise AssertionError(f"[lm-engine] (b) {mode}: "
                                 f"{runs[mode]['builds_after_warmup']} "
                                 "builds after warmup")
        if mode == "engine":
            split = lm_engine_split(torch, engine)
            saved = tune_cache.exists()
        for name in calls:
            model.__dict__.pop(name, None)
        del engine, results
        torch.cuda.empty_cache()
    mesh_run = lm_engine_mesh(runs.pop("wave_mesh"), runs["wave"],
                              tokens.pop("wave_mesh"), tokens["wave"],
                              logits)
    at.reset_default_autotuner()          # a restart: the tuner's cache lost
    restarted = ServingEngine(model, params, mode="engine", config=cfg,
                              plan=handle, device="cuda")
    restarted.warmup(shapes)
    restart = at.get_default_autotuner().stats()
    del restarted
    torch.cuda.empty_cache()
    equal = {mode: tokens[mode] == tokens["engine"] for mode in tokens}
    out = dict(config=dict(LM_LUT_ENGINE, autotune_cache=str(
        tune_cache.relative_to(ROOT))), requests=LM_LUT_REQUESTS,
               shapes=sorted(set(shapes)), runs=runs,
               tokens_equal_to_engine=equal, mesh=mesh_run,
               autotune_cache=dict(saved_by_warmup=saved, restart=restart))
    print("[lm-engine] (b) " + json.dumps(out, sort_keys=True), flush=True)
    if not all(equal.values()):
        differ = {mode: sum(a != b for x, y in zip(t, tokens["engine"])
                            for a, b in zip(x, y))
                  for mode, t in tokens.items()}
        raise AssertionError(f"[lm-engine] (b) greedy tokens differ across "
                             f"modes: {differ} of "
                             f"{sum(len(t) for t in tokens['engine'])}")
    if not (saved and restart["hits"] and restart["retune_events"] == 0):
        raise AssertionError(f"[lm-engine] (b) autotune_cache: saved after "
                             f"warmup {saved}, the restarted engine's tuner "
                             f"{restart}")
    out["split"] = split
    out["sums"] = lm_engine_sums(torch, model, params, handle, cfg,
                                 shapes, requests, tokens["engine"])
    return out


def recording_host(engine):
    """Record every float32 logits array the engine reads back to the host
    (its `_host`), in order; returns the list it fills."""
    seen = []
    host = engine._host

    def record(rows, vocab):
        out = host(rows, vocab)
        seen.append(out)
        return out

    engine._host = record
    return seen


def lm_engine_mesh(mesh, wave, mesh_tokens, wave_tokens, logits):
    """[mesh] engine: the wave engine on a MESH_REQUEST_SHARDS-shard request
    mesh (every shard on cuda:0) against the wave engine without it, both
    from `lm_engine_lut`'s loop: tokens and every float32 logits array
    bit-equal, K2 launches and forward calls MESH_REQUEST_SHARDS times the
    unsharded run's while serving (each shard's rows run the built step;
    `lm_engine_lut`'s loop holds K2 to 7 launches a layer a forward call).
    Returns
    the metrics."""
    got, want = logits["wave_mesh"], logits["wave"]
    logits_equal = (len(got) == len(want)
                    and all(np.array_equal(a, b) for a, b in zip(got, want)))
    # forward calls while serving: each build runs its step once at warmup
    # (the shards on cuda:0 share one build a bucket)
    fwd = sum(mesh["forward_calls"].values()) - mesh["builds"]
    fwd_wave = sum(wave["forward_calls"].values()) - wave["builds"]
    per_call = wave["launches"]["K2"] / sum(wave["forward_calls"].values())
    out = dict(shards=MESH_REQUEST_SHARDS, tokens_equal=mesh_tokens
               == wave_tokens, logits_equal=logits_equal,
               logits_arrays=len(got),
               k2_launches=mesh["launches"]["K2"],
               k2_launches_unsharded=wave["launches"]["K2"],
               serve_forward_calls=fwd,
               serve_forward_calls_unsharded=fwd_wave,
               k2_launches_per_step=per_call * fwd / fwd_wave,
               k2_launches_per_step_unsharded=per_call,
               tokens_per_s=mesh["tokens_per_s"],
               tokens_per_s_unsharded=wave["tokens_per_s"],
               builds_after_warmup=mesh["builds_after_warmup"],
               run_s=mesh["warmup_s"] + mesh["wall_s"],
               peak_mem_gb=mesh["peak_mem_gb"])
    print("[mesh] engine " + json.dumps(out, sort_keys=True), flush=True)
    if not (out["tokens_equal"] and logits_equal):
        raise AssertionError(f"[mesh] engine: sharded wave != unsharded "
                             f"wave: {out}")
    if fwd != MESH_REQUEST_SHARDS * fwd_wave:
        raise AssertionError(f"[mesh] engine: forward calls {out}")
    return out


def lm_engine_compare(torch, target, plan, stage_results):
    """(c) The stage's trace through a ``lut_serve=True`` engine of the same
    config and model: the share of greedy tokens equal to the fake-quant
    engine's (reported, not gated: the straight-through weight is the
    artifact's only up to a rounding: the [lm-serve] witness)."""
    import dataclasses

    from repro_torch.pipeline.targets import lm_serve_trace
    from repro_torch.serving import PlanHandle, ServingEngine

    cfg = lm_config().with_overrides({"serve": LM_STAGE_SERVE})
    shapes, ecfg, requests = lm_serve_trace(cfg.serve, target.acfg.vocab)
    engine = ServingEngine(
        target.model, plan.params, config=dataclasses.replace(
            ecfg, lut_serve=True),
        plan=PlanHandle.from_comp(plan.comp, compress_k=LM_COMPRESS_K),
        device="cuda")
    engine.warmup(shapes)
    lut = engine.serve(requests)
    fq = [stage_results[r].tokens for r in sorted(stage_results)]
    pairs = [(a, b) for x, y in zip(fq, [r.tokens for r in lut])
             for a, b in zip(x, y)]
    out = dict(tokens=len(pairs),
               equal_share=sum(a == b for a, b in pairs) / len(pairs),
               requests_equal=sum(x == r.tokens for x, r in zip(fq, lut)))
    print("[lm-engine] (c) fake-quant vs LUT engine: "
          + json.dumps(out, sort_keys=True), flush=True)
    del engine
    torch.cuda.empty_cache()
    return out


def lm_engine_phase(torch, plan):
    """[lm-engine]: the serving engine at olmo-1b's full width on the [lm]
    plan: (a) the pipeline's serve stage, (b) the packed-LUT engine in each
    mode with its step split, (c) the two engines' greedy tokens."""
    t_phase = time.perf_counter()
    stage, target = lm_engine_stage(torch, plan)
    torch.cuda.empty_cache()
    lut = lm_engine_lut(torch, target, plan)
    compare = lm_engine_compare(torch, target, plan,
                                target.last_serve_results)
    out = dict(stage=stage, lut=lut, compare=compare,
               phase_wall_s=time.perf_counter() - t_phase)
    print(f"[lm-engine] phase {out['phase_wall_s']:.1f} s", flush=True)
    return out


def lm_attached(torch, target, plan, tag):
    """The plan's comp tree with the serve artifacts attached, stacked
    over layers (and experts) (`attach_serve_artifacts`), each slice's held
    equal to the exported one (``blocks/g0/attn/wq[3]``,
    ``blocks/g0/moe/w_up[1][e5]``; a tail unit's unstacked). Returns (comp
    tree, attached unit count)."""
    from repro_torch.core.lm_compress import attach_serve_artifacts

    comp_serve, n = attach_serve_artifacts(target.model, plan.params,
                                           plan.comp)
    for name, art in plan.artifacts.items():
        unit, *idx = name.replace("]", "").split("[")
        idx = [int(i.lstrip("e")) for i in idx]   # layer, then expert
        parts = unit.split("/")
        node = (comp_serve[parts[0]] if parts[0] == "enc_blocks"
                else comp_serve[parts[0]][parts[1]])
        attached = node["/".join(parts[-2:])]["serve"]
        for f in ("packed", "codebook", "scale"):
            got = getattr(attached, f)
            for i in idx:
                got = got[i]
            if not torch.equal(got, getattr(art, f)):
                raise AssertionError(f"[{tag}] {name}.{f}: attached "
                                     "artifact != exported artifact")
    return comp_serve, n


def lm_phase(torch, ops, ref, work):
    """[lm]: olmo-1b at full width and depth on the card. The pipeline
    through export (`lm_export_path`); K2 on the LM's shapes; K3's one
    launch over the stacked units; the serve artifacts stacked over layers
    (`lm_attached`, held equal to the exported ones); served vs
    fake-quant prefill and decode at float32 (gated) and at the config's
    bfloat16 (reported); where a served step's time goes."""
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import lut_matmul as k2

    t_phase = time.perf_counter()
    target, plan, metrics = lm_export_path(torch)
    k2_rows = k2_phase(torch, ops, ref, lm_k2_cases(torch, target.acfg))
    k3_out = lm_k3_phase(torch, target.model, plan.params, plan.comp)
    torch.cuda.empty_cache()
    comp_serve, n = lm_attached(torch, target, plan, "lm")
    launched = {"K2": k2.launches, "K3": k3.launches}
    k2.launches = k3.launches = 0
    serve = {dt: lm_serve_phase(torch, target, plan, comp_serve, dt)
             for dt in ("float32", LM_CDTYPE)}
    lm_launches = {"K2": k2.launches, "K3": k3.launches}
    k2.launches, k3.launches = launched["K2"], launched["K3"]
    parts = lm_breakdown(torch, target, plan, comp_serve)
    del comp_serve
    torch.cuda.empty_cache()
    engine = lm_engine_phase(torch, plan)
    torch.cuda.empty_cache()
    fleet = lm_fleet_phase(torch, target, plan, work)
    k2.launches, k3.launches = launched["K2"], launched["K3"]
    metrics.update(stacked_units_attached=n, serve=serve, engine=engine,
                   fleet=fleet,
                   serve_path_launches=lm_launches, breakdown=parts,
                   phase_wall_s=time.perf_counter() - t_phase,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("[lm] " + json.dumps({k: v for k, v in metrics.items()
                                if k not in ("serve", "breakdown", "engine",
                                             "fleet")},
                               sort_keys=True), flush=True)
    del plan, target
    torch.cuda.empty_cache()
    return metrics, k2_rows, k3_out


# ------------------------------------------------------------- LM fleet


def fleet_requests(vocab):
    """(burst, trickle) of the [lm-fleet] traffic: seeded numpy prompts of
    LM_FLEET_PROMPT_LEN tokens, LM_FLEET_NEW_TOKENS new tokens each; the
    burst alternates two tenants."""
    from repro_torch.serving import ServeRequest

    def request(i, tenant):
        rng = np.random.default_rng(LM_FLEET_PROMPT_SEED + i)
        return ServeRequest(
            tokens=rng.integers(0, vocab, LM_FLEET_PROMPT_LEN).astype(
                np.int32),
            max_new_tokens=LM_FLEET_NEW_TOKENS, tenant=tenant)

    burst = [request(i, f"tenant{i % 2}") for i in range(LM_FLEET_BURST)]
    trickle = [request(LM_FLEET_BURST + i, "tenant0")
               for i in range(LM_FLEET_TRICKLE)]
    return burst, trickle


def per_plan_counts(fleet, calls):
    """{plan_id: {"K2", "K3", "forward_calls"}} counted from now on, each
    engine's warmup and scheduler steps attributed to its plan (the router
    runs one engine at a time)."""
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import lut_matmul as k2

    counts = {pid: {"K2": 0, "K3": 0, "forward_calls": 0}
              for pid in fleet.engines}
    for pid, engine in fleet.engines.items():
        for name in ("warmup", "step"):
            def counted(*a, _pid=pid, _fn=getattr(engine, name), **kw):
                before = (k2.launches, k3.launches, sum(calls.values()))
                out = _fn(*a, **kw)
                c = counts[_pid]
                c["K2"] += k2.launches - before[0]
                c["K3"] += k3.launches - before[1]
                c["forward_calls"] += sum(calls.values()) - before[2]
                return out
            setattr(engine, name, counted)
    return counts


def fleet_gates(fleet, rep, tag):
    """The router's gates: the burst degrades to the last level without
    flapping, level changes at least `hysteresis` submissions apart; the
    trickle recovers to level 0; accounting sums to the totals; no build
    after warmup."""
    levels = [e["level"] for e in fleet.route_log]
    burst, trickle = levels[:LM_FLEET_BURST], levels[LM_FLEET_BURST:]
    last = len(fleet.levels) - 1
    if burst != sorted(burst) or burst[0] != 0 or burst[-1] != last:
        raise AssertionError(f"[lm-fleet] {tag}: burst levels {burst}")
    change_at = [i for i in range(1, len(burst)) if burst[i] != burst[i - 1]]
    if any(b - a < fleet.router.hysteresis
           for a, b in zip(change_at, change_at[1:])):
        raise AssertionError(f"[lm-fleet] {tag}: level flapped {burst}")
    if trickle != sorted(trickle, reverse=True) or trickle[-1] != 0:
        raise AssertionError(f"[lm-fleet] {tag}: trickle levels {trickle}")
    for part in ("plans", "tenants"):
        for key in ("requests", "new_tokens"):
            got = sum(p[key] for p in rep[part].values())
            if got != rep[key]:
                raise AssertionError(f"[lm-fleet] {tag}: {part} {key} sum "
                                     f"{got} != {rep[key]}")
        got = sum(p["energy_eu"] for p in rep[part].values())
        if abs(got - rep["energy_eu_total"]) > 1e-6 * rep["energy_eu_total"]:
            raise AssertionError(f"[lm-fleet] {tag}: {part} energy sum")
    if rep["requests"] != LM_FLEET_BURST + LM_FLEET_TRICKLE:
        raise AssertionError(f"[lm-fleet] {tag}: {rep['requests']} served")
    if rep["recompiles_after_warmup"]:
        raise AssertionError(f"[lm-fleet] {tag}: "
                             f"{rep['recompiles_after_warmup']} builds after "
                             "warmup")


def lm_fleet_run(torch, model, params, lut, mode="engine", mesh=None):
    """One fleet of base / k8 / k4 over the [lm] parameters driven through
    the burst then the trickle (each trickle request drained before the
    next), its engines in ``mode``, on ``mesh`` when given. The router's
    gates (`fleet_gates`) hold for the slot engines' pressure; other modes
    are compared with each other instead. Returns (metrics, fleet, requests
    in submit order, results)."""
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.serving import (
        EngineConfig,
        FleetRouter,
        PlanHandle,
        RouterConfig,
    )

    tag = ("lut" if lut else "fake_quant") + (
        "" if mode == "engine" else f" {mode}") + (
        "" if mesh is None else f" mesh x{mesh.size}")
    calls = counting_calls(model)
    handles = [PlanHandle.uncompressed()] + [
        PlanHandle.from_compress_k(model, k, device="cuda")
        for k in LM_FLEET_K]
    ecfg = EngineConfig(**LM_FLEET_ENGINE, lut_serve=lut)
    torch.cuda.reset_peak_memory_stats()
    fleet = FleetRouter(model, params, handles, mode=mode, config=ecfg,
                        router=RouterConfig(**LM_FLEET_ROUTER), mesh=mesh,
                        device="cuda")
    counts = per_plan_counts(fleet, calls)
    k2_start = k2.launches
    t0 = time.perf_counter()
    fleet.warmup([(LM_FLEET_PROMPT_LEN, LM_FLEET_NEW_TOKENS)])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    k2_warmup = k2.launches - k2_start
    burst, trickle = fleet_requests(model.cfg.vocab)
    rids = [fleet.submit(r) for r in burst]
    out = fleet.run()
    for r in trickle:
        rids.append(fleet.submit(r))
        out = fleet.run()
    torch.cuda.synchronize()
    results = [out[rid] for rid in rids]
    rep = fleet.report()
    for name in calls:
        model.__dict__.pop(name, None)
    metrics = dict(
        engine=LM_FLEET_ENGINE, lut_serve=lut, warmup_s=warm_s,
        k2_warmup_launches=k2_warmup,
        levels=[h.plan_id for h in fleet.levels],
        energy_per_token={h.plan_id: h.energy_per_token
                          for h in fleet.levels},
        route_levels=[e["level"] for e in fleet.route_log],
        level_degrades=rep["level_degrades"],
        level_recovers=rep["level_recovers"],
        plan_requests={pid: p["requests"] for pid, p in rep["plans"].items()},
        tenant_requests={t: v["requests"] for t, v in rep["tenants"].items()},
        recompiles_after_warmup=rep["recompiles_after_warmup"],
        per_plan=counts,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        **serve_numbers(rep))
    print(f"[lm-fleet] {tag} " + json.dumps(metrics, sort_keys=True),
          flush=True)
    if mode == "engine":
        fleet_gates(fleet, rep, tag)
    n_units = 7 * model.cfg.n_layers
    for h in fleet.levels:
        c = counts[h.plan_id]
        if not h.compressed:
            want = {"K2": 0, "K3": 0}
        elif lut:
            want = {"K2": n_units * c["forward_calls"], "K3": 0}
        else:
            want = {"K2": 0, "K3": c["forward_calls"]}
        got = {"K2": c["K2"], "K3": c["K3"]}
        if got != want or (h.compressed and not c["forward_calls"]):
            raise AssertionError(f"[lm-fleet] {tag} {h.plan_id}: launches "
                                 f"{got}, expected {want} for "
                                 f"{c['forward_calls']} forward calls")
    return metrics, fleet, burst + trickle, results


def lm_fleet_pinned(torch, model, params, fleet, requests, results):
    """Routed == pinned: for each plan, an engine pinned to it (engine mode)
    serves the requests the router sent there; their tokens must be the
    routed ones."""
    from repro_torch.serving import ServingEngine

    out = {}
    for h in fleet.levels:
        mine = [i for i, e in enumerate(fleet.route_log)
                if e["plan_id"] == h.plan_id]
        engine = ServingEngine(model, params, mode="engine",
                               config=fleet.config, plan=h, device="cuda")
        pinned = engine.serve([requests[i] for i in mine])
        equal = sum(results[i].tokens == r.tokens
                    for i, r in zip(mine, pinned))
        out[h.plan_id] = {"requests": len(mine), "equal": equal}
        del engine
        torch.cuda.empty_cache()
    print("[lm-fleet] routed == pinned " + json.dumps(out, sort_keys=True),
          flush=True)
    if any(v["equal"] != v["requests"] for v in out.values()):
        raise AssertionError(f"[lm-fleet] routed tokens != pinned: {out}")
    return out


def lm_fleet_mesh(torch, model, params):
    """[mesh] fleet: the LUT fleet of [lm-fleet] with wave engines, without
    and with a MESH_REQUEST_SHARDS-shard request mesh on cuda:0 (the slot
    engines run a mesh's rows on its first device: nothing to split), the
    same burst and trickle: route log and tokens equal, K2 launches while
    serving (after the warmup's builds) MESH_REQUEST_SHARDS times the
    unsharded run's. Returns the metrics."""
    from repro_torch.distributed.sharding import request_mesh
    from repro_torch.kernels.lut_matmul import lut_matmul as k2

    t_phase = time.perf_counter()
    runs = {}
    for name, mesh in (("wave", None), ("wave_mesh", card_mesh(
            torch, request_mesh, MESH_REQUEST_SHARDS))):
        k2.launches = 0
        metrics, fleet, _, results = lm_fleet_run(torch, model, params, True,
                                                  "wave", mesh)
        runs[name] = dict(k2_launches=k2.launches,
                          k2_serve_launches=k2.launches
                          - metrics["k2_warmup_launches"],
                          tokens_per_s=metrics["tokens_per_s"],
                          route_log=list(fleet.route_log),
                          tokens=[r.tokens for r in results])
        del fleet, results
        torch.cuda.empty_cache()
    plain, meshed = runs["wave"], runs["wave_mesh"]
    out = dict(shards=MESH_REQUEST_SHARDS,
               route_log_equal=meshed["route_log"] == plain["route_log"],
               tokens_equal=meshed["tokens"] == plain["tokens"],
               route_levels=[e["level"] for e in meshed["route_log"]],
               k2_launches=meshed["k2_launches"],
               k2_launches_unsharded=plain["k2_launches"],
               k2_serve_launches=meshed["k2_serve_launches"],
               k2_serve_launches_unsharded=plain["k2_serve_launches"],
               tokens_per_s=meshed["tokens_per_s"],
               tokens_per_s_unsharded=plain["tokens_per_s"],
               phase_s=time.perf_counter() - t_phase)
    print("[mesh] fleet " + json.dumps(out, sort_keys=True), flush=True)
    if not (out["route_log_equal"] and out["tokens_equal"]):
        raise AssertionError(f"[mesh] fleet: the meshed fleet routed or "
                             f"served otherwise: {out}")
    if out["k2_serve_launches"] != MESH_REQUEST_SHARDS * out[
            "k2_serve_launches_unsharded"]:
        raise AssertionError(f"[mesh] fleet: launches {out}")
    return out


def lm_fleet_stage(torch, plan, work):
    """``serve --plan-in <the [lm] plan> --plans k4 base`` through the
    CLI, in process, as a user runs it: the plan saved as the [lm] phase's
    export left it (the [lm-engine] stage since ran its serve stage on the
    same object)."""
    import dataclasses

    from repro_torch.pipeline import cli
    from repro_torch.pipeline.plan import CompressionPlan

    base = work / "lm_plan"
    exported = dataclasses.replace(
        plan, completed=tuple(st for st in plan.completed if st != "serve"),
        metrics={k: v for k, v in plan.metrics.items()
                 if not k.startswith("serve_")})
    t0 = time.perf_counter()
    exported.save(base)
    save_s = time.perf_counter() - t0
    served = work / "lm_plan_fleet"
    t0 = time.perf_counter()
    rc = cli.main(["serve", "--plan-in", str(base), "--plans", "k4", "base",
                   "--device", "cuda", "--plan-out", str(served)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = CompressionPlan.load(served).metrics
    out = dict(rc=rc, plan_save_s=save_s, command_wall_s=wall,
               **{k: m[k] for k in (
                   "serve_mode", "serve_plans", "serve_requests",
                   "serve_new_tokens", "serve_tokens_per_s",
                   "serve_recompiles_after_warmup", "serve_level_degrades",
                   "serve_level_recovers")})
    print("[lm-fleet] stage " + json.dumps(out, sort_keys=True), flush=True)
    want_requests = exported.config["serve"]["requests"]
    if (rc != 0 or m["serve_mode"] != "fleet"
            or m["serve_requests"] != want_requests
            or m["serve_recompiles_after_warmup"] != 0):
        raise AssertionError(f"[lm-fleet] stage: {out}, expected every one "
                             f"of {want_requests} requests served and 0 "
                             "builds after warmup")
    for p in work.glob("lm_plan*"):
        p.unlink()
    return out


def lm_fleet_phase(torch, target, plan, work):
    """[lm-fleet]: the fleet router over three plans of the [lm] model at
    full width and LM_FLEET_LAYERS of its layers (base, k8, k4; fake-quant
    engines, then LUT engines), the routed tokens against pinned engines,
    then the CLI's fleet stage on the whole [lm] plan."""
    import dataclasses

    from repro_torch._device import tree_map
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.models.lm import build_lm

    t_phase = time.perf_counter()
    model = build_lm(dataclasses.replace(target.acfg,
                                         n_layers=LM_FLEET_LAYERS))
    params = dict(plan.params, blocks=tree_map(
        lambda t: t[:LM_FLEET_LAYERS], plan.params["blocks"]))
    k2.launches = k3.launches = 0
    fq, fleet, requests, results = lm_fleet_run(torch, model, params, False)
    fq["launches"] = {"K2": k2.launches, "K3": k3.launches}
    pinned = lm_fleet_pinned(torch, model, params, fleet, requests, results)
    del fleet, results
    torch.cuda.empty_cache()
    k2.launches = k3.launches = 0
    lut, fleet, _, _ = lm_fleet_run(torch, model, params, True)
    lut["launches"] = {"K2": k2.launches, "K3": k3.launches}
    del fleet
    torch.cuda.empty_cache()
    mesh = lm_fleet_mesh(torch, model, params)
    stage = lm_fleet_stage(torch, plan, work)
    out = dict(fake_quant=fq, lut=lut, pinned=pinned, stage=stage, mesh=mesh,
               phase_wall_s=time.perf_counter() - t_phase)
    print(f"[lm-fleet] phase {out['phase_wall_s']:.1f} s", flush=True)
    return out


# ------------------------------------------------------------ LM training


class _Captured:
    """Patches `LMTarget.stage_profile` (and `LMModel.forward`, counted)
    while open; records each profile stage's (target, plan)."""

    def __init__(self):
        self.runs = []
        self.forwards = 0

    def __enter__(self):
        from repro_torch.models.lm import LMModel
        from repro_torch.pipeline.targets import LMTarget

        self._real = (LMTarget.stage_profile, LMModel.forward)
        profile, forward = self._real

        def stage_profile(target, plan, cfg, verbose=False):
            self.runs.append((target, plan))
            return profile(target, plan, cfg, verbose=verbose)

        def counted(model, *a, **kw):
            self.forwards += 1
            return forward(model, *a, **kw)

        LMTarget.stage_profile, LMModel.forward = stage_profile, counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models.lm import LMModel
        from repro_torch.pipeline.targets import LMTarget

        LMTarget.stage_profile, LMModel.forward = self._real


def qat_numbers(torch, qat, peak):
    step_ms = [s * 1e3 for s in qat["step_s"]]
    return dict(steps=len(step_ms), first_step_ms=step_ms[0],
                median_step_ms=statistics.median(step_ms[1:] or step_ms),
                loss_first=qat["loss"][0], loss_last=qat["loss"][-1],
                losses=qat["loss"], peak_mem_gb=peak)


def backward_variants(torch, model, params, batch_size):
    """The QAT step's correctly rounded products with each backward: the
    shipped `exact_matmul` (its backward sums in float64 from the operands
    as given), the same function summing in float32 (the JAX package's
    backward), and autograd through the float64 product (the parent's,
    which keeps float64 copies of every operand). Step ms (median of the
    steps after the first) and peak memory each, at ``batch_size``
    sequences of 64 tokens."""
    from repro_torch.core.lm_compress import init_lm_comp
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.launch.train import (
        StepConfig,
        make_optimizer,
        make_train_step,
    )
    from repro_torch.kernels.lut_matmul import ref
    from repro_torch.nn import attention, layers

    class Float32Backward(ref._ExactMatmul):
        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            return ref.matmul_grads(a, b, g, torch.float32,
                                    ctx.needs_input_grad)

    variants = {
        "float64": None,
        "float32": lambda a, b: Float32Backward.apply(a, b),
        "float64_autograd": lambda a, b: (a.double() @ b.double()).float(),
    }
    comp = init_lm_comp(model, device="cuda")
    x, y = SyntheticTokens(vocab=model.cfg.vocab, seed=7).batch(
        0, batch_size, 64, device="cuda")
    batch = {"tokens": x, "labels": y}
    real = (layers.exact_matmul, attention.exact_matmul)
    out = {}
    for variant, fn in variants.items():
        if fn is not None:
            layers.exact_matmul = attention.exact_matmul = fn
        cfg = StepConfig(qat=True, with_comp=True, remat=False, q_block=128,
                         kv_block=128, lr=6e-4)
        step = make_train_step(model, cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = {"params": params, "opt": make_optimizer(cfg).init(params)}
        times, losses = [], []
        try:
            for _ in range(LM_BACKWARD_STEPS):
                t0 = time.perf_counter()
                state, m = step(state, batch, comp)
                losses.append(float(m["loss"]))
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            layers.exact_matmul, attention.exact_matmul = real
        out[variant] = dict(step_ms=times,
                            median_step_ms=statistics.median(times[1:]),
                            losses=losses,
                            peak_mem_gb=torch.cuda.max_memory_allocated()
                            / 1e9)
        del state, step
    torch.cuda.empty_cache()
    print(f"[lm-train] exact_matmul backward, batch {batch_size} x 64 "
          + json.dumps(out, sort_keys=True), flush=True)
    return out


def lm_train_phase(torch, work):
    """[lm-train]: what a user of the train entry points runs at olmo-1b's
    full width. `repro_torch.launch.train.main` (LM_TRAIN_STEPS QAT steps
    at batch LM_TRAIN_BATCH x 64 tokens, the plan saved): losses, step ms,
    peak memory, K3 launches against forward calls; the exact products'
    backward both ways; ``compress --target lm --arch olmo-1b --steps 2``
    through the CLI (the pipeline's default batch of 64 x 64 tokens, then
    the rest of its default path); then the trained params checkpointed and
    restored through ``--ckpt-dir``, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.launch import train as launch_train
    from repro_torch.pipeline import cli

    t_phase = time.perf_counter()
    out = {}
    k3.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _Captured() as cap:
        rc = launch_train.main([
            "--arch", LM_ARCH, "--steps", str(LM_TRAIN_STEPS),
            "--batch-size", str(LM_TRAIN_BATCH),
            "--plan-out", str(work / "lm_train"), "--device", "cuda"])
    torch.cuda.synchronize()
    target, plan = cap.runs[0]
    train = qat_numbers(torch, target.last_qat,
                        torch.cuda.max_memory_allocated() / 1e9)
    train.update(rc=rc, command_wall_s=time.perf_counter() - t0,
                 k3_launches=k3.launches, forward_calls=cap.forwards,
                 energy_per_token=plan.metrics["energy_per_token"],
                 wall_s_profile=plan.metrics["wall_s_profile"])
    out["train"] = train
    print("[lm-train] launch.train " + json.dumps(train, sort_keys=True),
          flush=True)
    losses = train["losses"]
    if rc != 0 or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[lm-train] losses {losses}: every loss "
                             "finite and the last below the first required")
    if not k3.launches == cap.forwards == LM_TRAIN_STEPS:
        raise AssertionError(f"[lm-train] {k3.launches} K3 launches for "
                             f"{cap.forwards} forward calls and "
                             f"{LM_TRAIN_STEPS} steps: one a forward")
    for p in work.glob("lm_train.*"):
        p.unlink()

    out["backward"] = {
        str(b): backward_variants(torch, target.model, plan.params, b)
        for b in (LM_TRAIN_BATCH, LM_COMPRESS_BATCH)}

    ckpt = work / "lm_ckpt"
    t0 = time.perf_counter()
    manager = CheckpointManager(ckpt, keep=1)
    manager.save(LM_TRAIN_STEPS, {"params": plan.params})
    manager.wait()
    save_s = time.perf_counter() - t0
    saved = plan.params
    del target, plan, cap
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _Captured() as cap:
        rc = cli.main(["compress", "--target", "lm", "--arch", LM_ARCH,
                       "--steps", str(LM_COMPRESS_STEPS), "--device",
                       "cuda"])
    torch.cuda.synchronize()
    target, plan = cap.runs[0]
    compress = qat_numbers(torch, target.last_qat,
                           torch.cuda.max_memory_allocated() / 1e9)
    compress.update(rc=rc, command_wall_s=time.perf_counter() - t0,
                    batch=[plan.config["target"]["batch_size"], 64],
                    completed=list(plan.completed),
                    **{k: v for k, v in plan.metrics.items()
                       if k.startswith("wall_s_")})
    out["compress"] = compress
    print("[lm-train] compress " + json.dumps(compress, sort_keys=True),
          flush=True)
    if rc != 0 or not all(np.isfinite(compress["losses"])):
        raise AssertionError(f"[lm-train] compress: rc {rc}, losses "
                             f"{compress['losses']}")
    del target, plan, cap
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with _Captured() as cap:
        rc = launch_train.main(["--arch", LM_ARCH, "--steps", "0",
                                "--ckpt-dir", str(ckpt), "--device", "cuda"])
    restored = cap.runs[0][1].params
    names = sorted(leaves(saved))
    got, want = leaves(restored), leaves(saved)
    equal = sum(torch.equal(got[n], want[n]) for n in names)
    out["checkpoint"] = dict(rc=rc, leaves=len(names), equal=equal,
                             save_s=save_s,
                             restore_wall_s=time.perf_counter() - t0)
    print("[lm-train] checkpoint " + json.dumps(out["checkpoint"],
                                                sort_keys=True), flush=True)
    if rc != 0 or set(got) != set(want) or equal != len(names):
        raise AssertionError(f"[lm-train] checkpoint: {equal} of "
                             f"{len(names)} leaves restored bit for bit")
    del saved, restored, cap, got, want
    for p in sorted(ckpt.rglob("*"), reverse=True):
        p.unlink() if p.is_file() else p.rmdir()
    torch.cuda.empty_cache()
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[lm-train] phase {out['phase_wall_s']:.1f} s", flush=True)
    return out


class _ActQuant:
    """Patches `qat.fake_quant_act` while open. Records each call's int8
    codes and quantized value (on ``device``, the CPU by default); given
    ``replay`` (another instance's record), each call takes the recorded
    quantized value in place of its own (straight-through as before),
    records nothing and counts the codes where its own rounding differs:
    the run then takes the recorded rounding decisions."""

    def __init__(self, replay=None, device="cpu"):
        self.codes, self.values = [], []
        self.replay = replay
        self.device = device
        self.calls = self.flips = 0

    def __enter__(self):
        import torch

        from repro_torch.core import qat

        self._real = qat.fake_quant_act

        def fake_quant_act(a, cand_dim=None, *, token_dims=0):
            scale = qat._act_scale(a, cand_dim, token_dims)
            codes = qat._round_clip(a / scale)
            q = codes * scale
            if self.replay is not None:
                want = self.replay.codes[self.calls].to(a.device)
                self.flips += int((codes != want).sum())
                q = self.replay.values[self.calls].to(a.device)
            else:
                self.codes.append(codes.detach().to(self.device, torch.int8))
                self.values.append(q.detach().to(self.device))
            self.calls += 1
            return a + (q - a).detach()

        qat.fake_quant_act = fake_quant_act
        return self

    def __exit__(self, *exc):
        from repro_torch.core import qat

        qat.fake_quant_act = self._real


def step_gaps(torch, a, b):
    """(loss rel, {leaf: gradient rel-L2}) of step ``a`` against ``b``
    (state, metrics); the gradient is read from the first Adam moment (0.1 x
    the clipped gradient)."""
    (sa, ma), (sb, mb) = a, b
    loss_rel = abs(float(ma["loss"]) - float(mb["loss"])) \
        / abs(float(mb["loss"]))
    mu_a, mu_b = leaves(sa["opt"]["mu"]), leaves(sb["opt"]["mu"])
    grad = {n.rstrip("/"): float(torch.linalg.norm(
        (mu_a[n].cpu() - mu_b[n].cpu()).double())
        / max(float(torch.linalg.norm(mu_b[n].cpu().double())), 1e-30))
        for n in mu_b}
    return loss_rel, grad


def lm_train_parity_phase(torch):
    """[lm-train-parity]: one `make_train_step` step of the reduced olmo-1b
    (k = 8 codebooks, QAT) on the card and on the CPU from the same params,
    comp and numpy batch. The forward keeps the JAX package's float32 sums
    outside the products (norms, softmax, attention, RoPE's and SiLU's
    transcendentals), which round differently on the two devices, so an
    activation within an ulp of an int8 rounding boundary can take the next
    code on one of them and carry that to the loss and gradients (a flip:
    counted). Gates: the CPU step run on the card's int8 rounding decisions
    (`_ActQuant` replay) against the card's, loss rel LOSS_RTOL and every
    gradient leaf rel-L2 GRAD_RTOL (the CNN's card-vs-CPU gate); the CPU's
    own step, loss rel LOSS_RTOL, its gradients and flips reported. Then on
    the card: ``remat=True`` == ``remat=False`` bit for bit, and the flash
    backward against autograd through `blocked_attention`."""
    from repro_torch._device import tree_to
    from repro_torch.configs import get_config
    from repro_torch.core import lm_compress
    from repro_torch.launch.train import (
        StepConfig,
        make_optimizer,
        make_train_step,
    )
    from repro_torch.models.lm import build_lm
    from repro_torch.nn.attention import AttnDims, blocked_attention
    from repro_torch.nn.spec import init_params

    model = build_lm(get_config(LM_ARCH).scaled_down(
        compute_dtype="float32"))
    params = init_params(0, model.spec, "cpu")
    comp = lm_compress.restrict_all_codebooks(
        model, lm_compress.init_lm_comp(model, device="cpu"),
        lm_compress.symmetric_codebook_values(8))
    toks = np.random.default_rng(0).integers(
        0, model.cfg.vocab, (8, 65)).astype(np.int32)

    def step(device, remat=False):
        cfg = StepConfig(qat=True, with_comp=True, remat=remat, q_block=16,
                         kv_block=16, lr=1e-3)
        p = tree_to(params, device)
        state = {"params": p, "opt": make_optimizer(cfg).init(p)}
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=device),
                 "labels": torch.as_tensor(toks[:, 1:], device=device)}
        return make_train_step(model, cfg)(state, batch,
                                           tree_to(comp, device))

    with _ActQuant() as on_card:
        card = step("cuda")
    with _ActQuant() as on_cpu:
        cpu_own = step("cpu")
    with _ActQuant(replay=on_card) as replayed:
        cpu = step("cpu")
    own_flips = sum(int((a != b).sum())
                    for a, b in zip(on_card.codes, on_cpu.codes))
    n_codes = sum(c.numel() for c in on_card.codes)
    loss_rel, grad = step_gaps(torch, card, cpu)
    own_loss_rel, own_grad = step_gaps(torch, card, cpu_own)

    (r0, m0), (r1, m1) = step("cuda"), step("cuda", remat=True)
    f0, f1, f2 = leaves(r0), leaves(r1), leaves(step("cuda")[0])
    remat_equal = sum(torch.equal(f0[n], f1[n]) for n in f0)
    repeat_equal = sum(torch.equal(f0[n], f2[n]) for n in f0)

    g = torch.Generator().manual_seed(0)
    b, s, hkv, grp, hd = 2, 256, 2, 2, 64
    dims = AttnDims(d_model=hkv * grp * hd, n_heads=hkv * grp,
                    n_kv_heads=hkv, head_dim=hd, window=96)
    arrays = [torch.randn(shape, generator=g) for shape in (
        (b, s, hkv * grp, hd), (b, s, hkv, hd), (b, s, hkv, hd),
        (b, s, hkv * grp, hd))]
    flash = {}
    for use_flash in (False, True):
        ts = [a.cuda().requires_grad_(True) for a in arrays[:3]]
        o = blocked_attention(*ts, dims, q_block=64, kv_block=64,
                              use_flash=use_flash)
        (o * arrays[3].cuda()).sum().backward()
        flash[use_flash] = (o.detach(), [t.grad for t in ts])
    flash_fwd = float((flash[True][0] - flash[False][0]).abs().max())
    flash_grad = max(float(torch.linalg.norm((a - b_).double())
                           / torch.linalg.norm(b_.double()))
                     for a, b_ in zip(flash[True][1], flash[False][1]))
    grad_max = max(grad.values())
    out = dict(loss_card=float(card[1]["loss"]), loss_cpu=float(cpu[1]["loss"]),
               loss_rel=loss_rel, loss_margin=LOSS_RTOL / max(loss_rel,
                                                              1e-30),
               grad_rel_l2=grad, grad_rel_l2_max=grad_max,
               grad_margin=GRAD_RTOL / max(grad_max, 1e-30),
               replay_flips=replayed.flips, act_codes=n_codes,
               own=dict(loss_rel=own_loss_rel, grad_rel_l2=own_grad,
                        grad_rel_l2_max=max(own_grad.values()),
                        flips=own_flips),
               remat_equal_leaves=remat_equal, remat_leaves=len(f0),
               repeat_equal_leaves=repeat_equal,
               remat_loss_equal=bool(torch.equal(m0["loss"], m1["loss"])),
               flash_forward_max_abs=flash_fwd,
               flash_grad_rel_l2_max=flash_grad)
    print("[lm-train-parity] " + json.dumps(out, sort_keys=True), flush=True)
    if not (loss_rel <= LOSS_RTOL and grad_max <= GRAD_RTOL
            and own_loss_rel <= LOSS_RTOL):
        raise AssertionError(f"[lm-train-parity] card vs CPU: loss rel "
                             f"{loss_rel:.3e} (own rounding {own_loss_rel:.3e}"
                             f"), gradient rel-L2 max {grad_max:.3e}")
    if remat_equal != len(f0) or not out["remat_loss_equal"]:
        raise AssertionError(f"[lm-train-parity] remat: {remat_equal} of "
                             f"{len(f0)} leaves equal")
    if not (flash_fwd <= FLASH_FWD_ATOL and flash_grad <= FLASH_GRAD_RTOL):
        raise AssertionError(f"[lm-train-parity] flash vs blocked: forward "
                             f"{flash_fwd:.3e}, gradients {flash_grad:.3e}")
    return out


# ------------------------------------------------------- LM recurrent families


def recurrent_k2_cases(torch, arch):
    """`k2_phase` cases of the recurrent families' new (K, N) pairs at
    prefill (M = prompts x prompt length) and decode (M = prompts), each at
    float32 and bfloat16 X: mamba2's in_proj (2048 x 8512: a partial last
    column tile of 128) and out_proj (4096 x 2048); recurrentgemma's
    d x d units (RG-LRU projections, wq, wo: 2560 x 2560), its MQA wk/wv
    (2560 x 256), the GeGLU gate with its gelu epilogue (2560 x 7680) and
    w_down (7680 x 2560)."""
    shapes = {"mamba2-1.3b": [("in_proj", 2048, 8512, "none"),
                              ("out_proj", 4096, 2048, "none")],
              "recurrentgemma-2b": [("d x d", 2560, 2560, "none"),
                                    ("wk/wv", 2560, 256, "none"),
                                    ("gate", 2560, 7680, "gelu"),
                                    ("down", 7680, 2560, "none")]}[arch]
    short = arch.split("-")[0]
    cases = []
    for step, m in (("prefill", LM_PROMPTS * LM_PROMPT_LEN),
                    ("decode", LM_PROMPTS)):
        for x_dtype, tag in ((torch.float32, ""), (torch.bfloat16, " bf16")):
            for name, k, n, act in shapes:
                cases.append((f"{short} {step} {name}{tag}", m, k, k, n, act,
                              False, False, x_dtype, 0, True))
    return cases


def lm_roundtrip(torch, target, plan):
    """JAX's roundtrip contract (`tests/test_lm.py`) at full width: the
    float32 model (no QAT) prefills LM_PROMPTS seeded prompts of
    LM_PROMPT_LEN tokens, then decodes LM_DECODE_STEPS fed tokens; each
    position's logits against the full forward over all the tokens. Returns
    the max abs error over the real vocab (gated < ROUNDTRIP_ATOL)."""
    import dataclasses

    from repro_torch.models.lm import build_lm

    model = build_lm(dataclasses.replace(target.acfg,
                                         compute_dtype="float32"))
    vocab = model.cfg.vocab
    gen = torch.Generator(device="cuda").manual_seed(LM_PROMPT_SEED + 1)
    toks = torch.randint(0, vocab, (LM_PROMPTS,
                                    LM_PROMPT_LEN + LM_DECODE_STEPS),
                         generator=gen, device="cuda", dtype=torch.int32)
    with torch.no_grad():
        full = model.forward(plan.params, toks)[0][..., :vocab]
        lg, cache = model.prefill(plan.params, toks[:, :LM_PROMPT_LEN],
                                  LM_MAX_LEN, cache_dtype=torch.float32)
        errs = [float((lg[..., :vocab] - full[:, :LM_PROMPT_LEN]).abs()
                      .max())]
        for t in range(LM_PROMPT_LEN, toks.shape[1]):
            lg, cache = model.decode_step(plan.params, cache,
                                          toks[:, t:t + 1])
            errs.append(float((lg[:, 0, :vocab] - full[:, t]).abs().max()))
        scale = float(full.abs().max())
    del full, lg, cache
    torch.cuda.empty_cache()
    return dict(prefill_max_abs_err=errs[0], decode_max_abs_err=errs[1:],
                max_abs_err=max(errs), logit_max_abs=scale)


def lm_recurrent_breakdown(torch, target, plan, comp_serve):
    """Where a served float32 prefill's and decode step's time goes on a
    recurrent family (`breakdown`: each part's calls replayed alone): K2,
    the SSD (`ssm.ssd_chunked`) or the RG-LRU scan (`rglru.linear_scan`),
    the depthwise convs, the block norms and the SSD's gated norm, the
    activation fake-quant, attention and RoPE (recurrentgemma's local
    blocks), the unembedding, and ``other`` (the step less the parts)."""
    import dataclasses

    from repro_torch.core import export, qat
    from repro_torch.models.lm import build_lm
    from repro_torch.nn import attention, rglru, ssm, transformer
    from repro_torch.nn.layers import QuantConfig

    model = build_lm(dataclasses.replace(target.acfg,
                                         compute_dtype="float32"))
    gen = torch.Generator(device="cuda").manual_seed(LM_PROMPT_SEED)
    prompts = torch.randint(0, model.cfg.vocab, (LM_PROMPTS, LM_PROMPT_LEN),
                            generator=gen, device="cuda", dtype=torch.int32)
    targets = {"k2": (export, "lut_matmul_fused"),
               "norms": (transformer, "apply_norm"),
               "fake_quant_acts": (qat, "fake_quant_act"),
               "unembed": (model, "_unembed")}
    if "ssm" in model.cfg.pattern:
        targets.update(ssd=(ssm, "ssd_chunked"),
                       conv=(ssm, "_causal_depthwise_conv"),
                       gated_norm=(ssm, "_gated_norm"))
    else:
        targets.update(scan=(rglru, "linear_scan"),
                       conv=(rglru, "_causal_depthwise_conv"),
                       attention=(attention, "blocked_attention"),
                       decode_attention=(attention, "decode_attention"),
                       rope=(attention, "apply_rope"))
    qserve = QuantConfig.serve()
    parts = {}
    with torch.no_grad():
        _, cache = model.prefill(plan.params, prompts, LM_MAX_LEN,
                                 qcfg=qserve, comp=comp_serve,
                                 cache_dtype=torch.float32)
        tok = prompts[:, -1:]
        for step, forward in (
                ("prefill", lambda: model.prefill(
                    plan.params, prompts, LM_MAX_LEN, qcfg=qserve,
                    comp=comp_serve, cache_dtype=torch.float32)),
                ("decode_step", lambda: model.decode_step(
                    plan.params, cache, tok, qcfg=qserve,
                    comp=comp_serve))):
            ms, _ = breakdown(torch, forward, targets, 5)
            ms["other"] = ms["forward"] - sum(
                v for k, v in ms.items() if k not in ("forward", "calls"))
            parts[step] = ms
            torch.cuda.empty_cache()
    print(f"[lm-recurrent-breakdown] {model.cfg.name} "
          + json.dumps(parts, sort_keys=True), flush=True)
    return parts


def lm_recurrent_model(torch, ops, ref, arch, engine=False, keep=False):
    """One recurrent family at its published width and depth: the pipeline
    through export (`lm_export_path`: LM_RECURRENT_UNITS[arch] matmuls,
    LUT parity over each), K2 at the family's new shapes, K3's grouped
    launches (the stacked groups with the layer axis as candidates, and
    the tail's units) bit for bit, the stacked serve artifacts held equal
    to the exported ones, served vs fake-quant prefill and decode at
    float32 (gated) and bfloat16 (reported), where a served step's time
    goes (`lm_recurrent_breakdown`), the roundtrip contract, and
    with ``engine`` the pipeline's serve stage on the plan
    (`lm_engine_stage`). Returns (metrics, K2 rows, K3 rows, the seeded
    parameters moved to the host with ``keep``, else None)."""
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import lut_matmul as k2

    t0 = time.perf_counter()
    tag = "lm-recurrent"
    target, plan, metrics = lm_export_path(
        torch, arch, LM_RECURRENT_UNITS[arch], tag)
    k2_rows = k2_phase(torch, ops, ref, recurrent_k2_cases(torch, arch),
                       LM_RECURRENT_K2_REPS)
    k3_rows = [lm_k3_phase(torch, target.model, plan.params, plan.comp, top,
                           f"{tag}-k3") for top in ("blocks", "tail")
               if top in plan.params]
    torch.cuda.empty_cache()
    comp_serve, n = lm_attached(torch, target, plan, tag)
    launched = {"K2": k2.launches, "K3": k3.launches}
    k2.launches = k3.launches = 0
    serve = {dt: lm_serve_phase(torch, target, plan, comp_serve, dt,
                                f"{tag}-serve")
             for dt in ("float32", "bfloat16")}
    serve_launches = {"K2": k2.launches, "K3": k3.launches}
    parts = lm_recurrent_breakdown(torch, target, plan, comp_serve)
    k2.launches, k3.launches = launched["K2"], launched["K3"]
    del comp_serve
    torch.cuda.empty_cache()
    roundtrip = lm_roundtrip(torch, target, plan)
    print(f"[{tag}] {arch} roundtrip " + json.dumps(roundtrip,
                                                   sort_keys=True),
          flush=True)
    if not roundtrip["max_abs_err"] < ROUNDTRIP_ATOL:
        raise AssertionError(f"[{tag}] {arch}: prefill + decode vs the full "
                             f"forward max abs err "
                             f"{roundtrip['max_abs_err']:.3e} >= "
                             f"{ROUNDTRIP_ATOL}")
    stage = None
    if engine:
        stage, _ = lm_engine_stage(torch, plan, arch,
                                   f"[{tag}-engine] {arch}")
        k2.launches, k3.launches = launched["K2"], launched["K3"]
    metrics.update(stacked_units_attached=n, serve=serve,
                   roundtrip=roundtrip, engine=stage, breakdown=parts,
                   serve_path_launches=serve_launches,
                   model_wall_s=time.perf_counter() - t0,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[{tag}] " + json.dumps({k: v for k, v in metrics.items()
                                    if k not in ("serve", "engine",
                                                 "breakdown")},
                                   sort_keys=True), flush=True)
    from repro_torch._device import tree_to

    kept = tree_to(plan.params, "cpu") if keep else None
    del plan, target
    torch.cuda.empty_cache()
    return metrics, k2_rows, k3_rows, kept


def lm_recurrent_train(torch, work):
    """(d) ``python -m repro_torch compress --config <json> --target lm
    --arch mamba2-1.3b --steps 2`` through the CLI, the config's only
    change from the default path the QAT batch (LM_RECURRENT_TRAIN_BATCH
    sequences of 64 tokens: at the default 64 the SSD's padded (l x l)
    products alone would keep ~2 GB a layer for the backward, 48 layers):
    losses, step ms, peak memory, K3 launches against forward calls."""
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.pipeline import cli
    from repro_torch.pipeline.config import PipelineConfig

    arch = LM_RECURRENT[0]
    cfg = PipelineConfig().with_overrides({"target": {
        "kind": "lm", "arch": arch,
        "batch_size": LM_RECURRENT_TRAIN_BATCH}})
    path = work / "lm_recurrent_train.json"
    path.write_text(json.dumps(cfg.to_dict()))
    k3.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _Captured() as cap:
        rc = cli.main(["compress", "--config", str(path), "--target", "lm",
                       "--arch", arch, "--steps", str(LM_COMPRESS_STEPS),
                       "--device", "cuda"])
    torch.cuda.synchronize()
    target, plan = cap.runs[0]
    out = qat_numbers(torch, target.last_qat,
                      torch.cuda.max_memory_allocated() / 1e9)
    out.update(rc=rc, command_wall_s=time.perf_counter() - t0,
               batch=[plan.config["target"]["batch_size"], 64],
               completed=list(plan.completed), k3_launches=k3.launches,
               forward_calls=cap.forwards,
               **{k: v for k, v in plan.metrics.items()
                  if k.startswith("wall_s_")})
    print("[lm-recurrent-train] compress " + json.dumps(out, sort_keys=True),
          flush=True)
    path.unlink()
    if rc != 0 or not all(np.isfinite(out["losses"])):
        raise AssertionError(f"[lm-recurrent-train] rc {rc}, losses "
                             f"{out['losses']}")
    if not k3.launches == cap.forwards == LM_COMPRESS_STEPS:
        raise AssertionError(f"[lm-recurrent-train] {k3.launches} K3 "
                             f"launches for {cap.forwards} forward calls "
                             f"and {LM_COMPRESS_STEPS} steps: one a forward")
    del target, plan, cap
    torch.cuda.empty_cache()
    return out


def lm_recurrent_phase(torch, ops, ref, work):
    """[lm-recurrent]: (a) mamba2-1.3b and (b) recurrentgemma-2b at their
    published widths and depths (`lm_recurrent_model`), (c) the serving
    engine on (a)'s plan, (d) mamba2's QAT through the CLI
    (`lm_recurrent_train`). Returns (metrics, K2 rows, K3 rows, (a)'s
    seeded parameters on the host, for [lm-scan])."""
    t0 = time.perf_counter()
    models, k2_rows, k3_rows, kept = {}, [], {}, None
    for arch in LM_RECURRENT:
        m, k2r, k3r, params = lm_recurrent_model(
            torch, ops, ref, arch, engine=arch == LM_RECURRENT[0],
            keep=arch == SCAN_ARCH)
        models[arch], k3_rows[arch] = m, k3r
        k2_rows += k2r
        kept = params if params is not None else kept
    train = lm_recurrent_train(torch, work)
    out = dict(models=models, train=train,
               phase_wall_s=time.perf_counter() - t0)
    print(f"[lm-recurrent] phase {out['phase_wall_s']:.1f} s", flush=True)
    return out, k2_rows, k3_rows, kept


# ------------------------------------------------------ routed LM targets


def routed_config(kind, arch):
    """The routed phases' config: `reduced_scan_config` /
    `reduced_moe_config` of ``arch`` at its published width
    (``reduced=False``): no LM QAT steps, the LM_COMPRESS_K floor, the
    routing section's defaults (2 calibration batches of 2 x 32 tokens, the
    k ladder 4 / 8 / 16), the reduced preset's small serve trace."""
    import dataclasses

    from repro_torch.pipeline.config import (
        reduced_moe_config,
        reduced_scan_config,
    )

    preset = {"moe": reduced_moe_config, "scan": reduced_scan_config}[kind]
    cfg = preset(arch, compress_k=LM_COMPRESS_K)
    return dataclasses.replace(cfg, target=dataclasses.replace(
        cfg.target, reduced=False))


class _Depth:
    """While open, the pipeline's targets build ``arch`` with its first
    ``n_layers`` layers (`repro_torch.pipeline.targets.get_config`
    patched): a depth cut, every width as published."""

    def __init__(self, arch, n_layers):
        self.arch, self.n_layers = arch, n_layers

    def __enter__(self):
        import dataclasses

        from repro_torch.pipeline import targets

        self._real = real = targets.get_config

        def get_config(name):
            cfg = real(name)
            if name == self.arch:
                cfg = dataclasses.replace(cfg, n_layers=self.n_layers)
            return cfg

        targets.get_config = get_config
        return self

    def __exit__(self, *exc):
        from repro_torch.pipeline import targets

        targets.get_config = self._real


def routed_gates(plan, tag, n_routed, per_layer):
    """The routed schedule's decisions: ``n_routed`` routed slices (a
    traffic share each); k monotone in the traffic share within each
    layer's experts (``per_layer``: MoE) or within each scan stack; the
    energy after below the energy before. Returns the summary."""
    from repro_torch.pipeline.targets import _slice_key

    groups, ks = {}, {}
    for d in plan.decisions:
        if "traffic_share" not in d:
            continue
        path, li, ei = _slice_key(d["layer"])
        key = (path, li) if per_layer else path
        groups.setdefault(key, []).append((d["traffic_share"], d["k"]))
        ks[d["k"]] = ks.get(d["k"], 0) + 1
    routed = sum(len(v) for v in groups.values())
    monotone = all(k0 <= k1 for pts in groups.values()
                   for (_, k0), (_, k1) in zip(sorted(pts), sorted(pts)[1:]))
    m = plan.metrics
    out = dict(routed_slices=routed, routed_units=m["routed_units"],
               k_counts={str(k): v for k, v in sorted(ks.items())},
               monotone=monotone, routing_tokens=m["routing_tokens"],
               energy_before=m["energy_before"],
               energy_after=m["energy_after"],
               energy_saving=1 - m["energy_after"] / m["energy_before"])
    print(f"[{tag}] routed " + json.dumps(out, sort_keys=True), flush=True)
    if routed != n_routed or m["routed_units"] != n_routed:
        raise AssertionError(f"[{tag}] {routed} routed slices "
                             f"({m['routed_units']} units), expected "
                             f"{n_routed}")
    if not monotone:
        raise AssertionError(f"[{tag}] k is not monotone in traffic share")
    if not m["energy_after"] < m["energy_before"]:
        raise AssertionError(f"[{tag}] energy_after {m['energy_after']} >= "
                             f"energy_before {m['energy_before']}")
    return out


def lm_scan_phase(torch, ops, ref, params_host):
    """[lm-scan]: `ScanTarget` on mamba2-1.3b at its published width and
    depth, from [lm-recurrent]'s seeded parameters: ``Pipeline(cfg,
    device="cuda")`` through export (calibration on the card, each of the
    48 layers' k from the ladder by its activity rank, 96 matmuls, LUT
    parity over each), the routed gates, served (96 K2 launches a forward)
    against fake-quant (one K3 launch a forward) prefill of 4 x 256 tokens
    and 8 decode steps at float32 (< 2e-2, the witness), then the same
    pipeline's serve stage (the fake-quant engine on the reduced preset's
    trace)."""
    from repro_torch._device import tree_to
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.pipeline.pipeline import Pipeline

    t_phase = time.perf_counter()
    tag = "lm-scan"
    pipe = Pipeline(routed_config("scan", SCAN_ARCH), device="cuda")
    pipe.plan.params = tree_to(params_host, "cuda")
    target, plan, metrics = lm_export_path(torch, SCAN_ARCH, SCAN_UNITS, tag,
                                           pipe=pipe)
    routed = routed_gates(plan, tag, SCAN_UNITS, per_layer=False)
    comp_serve, n = lm_attached(torch, target, plan, tag)
    k2.launches = k3.launches = 0
    serve = lm_serve_phase(torch, target, plan, comp_serve, "float32",
                           f"{tag}-serve", shared_codes=True,
                           own_code_gate=False)
    serve_launches = {"K2": k2.launches, "K3": k3.launches}
    del comp_serve
    torch.cuda.empty_cache()
    calls = counting_calls(target.model)
    k2.launches = k3.launches = 0
    t0 = time.perf_counter()
    pipe.run_until("serve", verbose=True)
    torch.cuda.synchronize()
    stage = dict(stage_wall_s=time.perf_counter() - t0,
                 forward_calls=dict(calls),
                 launches={"K2": k2.launches, "K3": k3.launches},
                 **{k[len("serve_"):]: v for k, v in plan.metrics.items()
                    if k.startswith("serve_")
                    and isinstance(v, (int, float, bool, str))})
    for name in calls:
        target.model.__dict__.pop(name, None)
    print(f"[{tag}] serve stage " + json.dumps(stage, sort_keys=True),
          flush=True)
    forwards = sum(calls.values())
    if stage["launches"] != {"K2": 0, "K3": forwards} or not forwards \
            or stage["recompiles_after_warmup"] != 0:
        raise AssertionError(f"[{tag}] serve stage: {stage}, expected one "
                             "K3 launch a forward call, no K2, no build "
                             "after warmup")
    metrics.update(routed=routed, stacked_units_attached=n, serve=serve,
                   serve_path_launches=serve_launches, stage=stage,
                   phase_wall_s=time.perf_counter() - t_phase)
    print(f"[{tag}] phase {metrics['phase_wall_s']:.1f} s", flush=True)
    del plan, target, pipe
    torch.cuda.empty_cache()
    return metrics


def moe_k2_cases(torch, acfg):
    """`k2_phase` cases of the MoE's expert matmuls: one LUT GEMM an
    (expert, matrix) at M = prompts x the expert capacity, C(256) = 40 in
    a prefill of LM_PROMPT_LEN tokens and C(1) = 8 in a decode step (`capacity`);
    w_gate / w_up (d x f) and w_down (f x d), float32 X."""
    from repro_torch.nn.moe import capacity

    dims = acfg.moe_dims()
    d, f = dims.d_model, dims.d_ff
    cases = []
    for step, s in (("prefill", LM_PROMPT_LEN), ("decode", 1)):
        m = LM_PROMPTS * capacity(dims, s)
        for name, k, n in (("w_gate/w_up", d, f), ("w_down", f, d)):
            cases.append((f"moe {step} {name}", m, k, k_pad(k), n, "none",
                          False, False, torch.float32, 0, True))
    return cases


def moe_k3_phase(torch, model, plan, tag="lm-moe-k3"):
    """K3 as a fake-quant forward of the MoE calls it
    (`LMModel._fake_quant_units`): one launch, the attention units with the
    layers as candidates and each expert unit with layers x experts (each
    expert its own scales and codebook), held against the plain version
    (the same entries through `ref.fake_quant_group_ref`) bit for bit; one
    call timed between CUDA events beside its bound and the plain
    version's. Returns the metrics."""
    from repro_torch.core import qat
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.fake_quant import ref as k3ref
    from repro_torch.nn.layers import QuantConfig

    def units():
        return model._fake_quant_units(plan.params, plan.comp,
                                       QuantConfig.on())

    def plain():
        real = k3.launch_group
        k3.launch_group = k3ref.fake_quant_group_ref
        try:
            return units()
        finally:
            k3.launch_group = real

    launched = k3.launches
    entries = []
    real_qat = qat.fake_quant_weights

    def recording(ws, comps, cands=None):
        entries.append((ws, comps, cands))
        return real_qat(ws, comps, cands)

    with torch.no_grad():
        qat.fake_quant_weights = recording
        try:
            got = units()
        finally:
            qat.fake_quant_weights = real_qat
        if k3.launches - launched != 1 or len(entries) != 1:
            raise AssertionError(f"[{tag}] {k3.launches - launched} launches "
                                 f"in {len(entries)} calls, expected 1")
        want = plain()
        torch.cuda.synchronize()
        max_err, n_leaves = 0.0, 0
        for g, node in got["blocks"].items():
            for unit, w in node.items():
                ref_w = want["blocks"][g][unit]
                max_err = max(max_err, float((w - ref_w).abs().max()))
                n_leaves += 1
                if not equal_nan(torch, w, ref_w):
                    raise AssertionError(
                        f"[{tag}] {g}/{unit} {tuple(w.shape)}: kernel "
                        f"differs from the plain version (max abs err "
                        f"{max_err:.3e}; required: equal)")
        del got, want
        torch.cuda.empty_cache()
        ms = time_turns(torch, {"kernel": units, "plain": plain}, 3)
    k3.launches = launched
    ws, comps, cands = entries[0]
    bound_ms, bound_by = k3_bound(ws, comps)
    out = dict(entries=len(ws), candidates=list(cands), units=n_leaves,
               weights=sum(w.numel() for w in ws), max_abs_err=max_err,
               device_ms=ms["kernel"], plain_ms=ms["plain"],
               timing="cuda events, one call", bound_ms=bound_ms,
               bound_by=bound_by,
               shapes=[list(w.shape) for w in ws])
    print(f"[{tag}] one launch of {len(ws)} entries (candidates {cands}; "
          f"{out['weights']:,} weights): equal to the plain version; "
          f"{ms['kernel']:.3f} ms (events), plain {ms['plain']:.1f} ms, "
          f"bound {bound_ms:.3f} ms ({bound_by})", flush=True)
    return out


class _MoEAux:
    """Records every `apply_moe` call's ``dropped_frac`` while open."""

    def __enter__(self):
        from repro_torch.nn import moe

        self.dropped = []
        self._real = real = moe.apply_moe

        def apply_moe(*a, **kw):
            y, aux = real(*a, **kw)
            self.dropped.append(float(aux["dropped_frac"]))
            return y, aux

        moe.apply_moe = apply_moe
        return self

    def __exit__(self, *exc):
        from repro_torch.nn import moe

        moe.apply_moe = self._real


def moe_dispatch_check(torch, model, params_host, params_card, tag):
    """Card against CPU on the same parameters and tokens, the MoE's first
    MOE_CHECK_LAYERS layers: `collect_lm_routing_stats` (the pipeline's
    calibration batches) on each device, the kept-dispatch counts and
    every token's top-k choices compared; the choices that differ are
    counted and stated (the router's float32 logits can differ by an ulp
    between the devices and flip a near-tie)."""
    import dataclasses

    from repro_torch._device import tree_map
    from repro_torch.core import routing_stats
    from repro_torch.models.lm import build_lm
    from repro_torch.nn import moe
    from repro_torch.pipeline.config import RoutingStageConfig

    r = RoutingStageConfig()
    small = build_lm(dataclasses.replace(model.cfg,
                                         n_layers=MOE_CHECK_LAYERS))
    runs = {}
    for dev, params in (("cuda", params_card), ("cpu", params_host)):
        cut = dict(params, blocks=tree_map(lambda t: t[:MOE_CHECK_LAYERS],
                                           params["blocks"]))
        chosen = []
        real = moe.top_k

        def recording(probs, k, _real=real, _chosen=chosen):
            v, i = _real(probs, k)
            _chosen.append(i.cpu())
            return v, i

        moe.top_k = recording
        t0 = time.perf_counter()
        try:
            stats = routing_stats.collect_lm_routing_stats(
                small, cut, batches=r.calib_batches,
                batch_size=r.calib_batch_size, seq_len=r.calib_seq_len,
                seed=r.calib_seed)
        finally:
            moe.top_k = real
        runs[dev] = (stats, chosen, time.perf_counter() - t0)
    (card, card_top, card_s), (cpu, cpu_top, cpu_s) = runs["cuda"], \
        runs["cpu"]
    flips = sum(int((a != b).sum()) for a, b in zip(card_top, cpu_top))
    n_choices = sum(a.numel() for a in card_top)
    unit = "blocks/g0/moe"
    diff = np.abs(card.moe_counts[unit] - cpu.moe_counts[unit])
    out = dict(layers=MOE_CHECK_LAYERS, tokens=card.tokens,
               choices=n_choices, choices_differing=flips,
               kept_counts_equal=bool((diff == 0).all()),
               kept_counts_abs_diff=float(diff.sum()),
               kept_counts_card=card.moe_counts[unit].tolist(),
               card_s=card_s, cpu_s=cpu_s)
    print(f"[{tag}] card vs CPU dispatch " + json.dumps(out, sort_keys=True),
          flush=True)
    if flips == 0 and not out["kept_counts_equal"]:
        raise AssertionError(f"[{tag}] equal top-k choices but kept counts "
                             f"differ: {out}")
    return out


def moe_engine_stage(torch, target, plan, tag):
    """The pipeline's serve stage on the MoE plan: ``Pipeline.from_plan(
    plan, device="cuda")`` through ``serve`` (the fake-quant engine) on
    LM_PROMPTS requests of LM_PROMPT_LEN prompt and LM_DECODE_STEPS new
    tokens, every forward call counted; then a oneshot engine on the same
    requests: the share of greedy tokens that agree is reported, not gated
    (a capacity depends on the call's sequence length, so the engine's
    chunked prefill and the oneshot prefill may drop different tokens, in
    the JAX package too). Gates: no build after warmup, one K3 launch a
    forward call, no K2. Reports tokens/s, TTFT, ms a step and each MoE
    call's dropped fraction."""
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.pipeline.pipeline import Pipeline
    from repro_torch.pipeline.targets import lm_serve_trace
    from repro_torch.serving import ServingEngine

    serve = dict(compress_k=LM_COMPRESS_K, requests=LM_PROMPTS,
                 prompt_len=LM_PROMPT_LEN, new_tokens=LM_DECODE_STEPS,
                 mixed=False, max_batch=LM_PROMPTS, verify_oneshot=False)
    cfg = routed_config("moe", MOE_ARCH).with_overrides({"serve": serve})
    pipe = Pipeline.from_plan(plan, cfg=cfg, device="cuda")
    calls = counting_calls(pipe.target.model)
    k2.launches = k3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _MoEAux() as aux:
        pipe.run_until("serve", verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K2": k2.launches, "K3": k3.launches}
    for name in calls:
        pipe.target.model.__dict__.pop(name, None)
    forwards = sum(calls.values())
    engine = pipe.target.last_serve_results
    shapes, ecfg, requests = lm_serve_trace(cfg.serve, target.acfg.vocab)
    oneshot = ServingEngine(pipe.target.model, plan.params, mode="oneshot",
                            config=ecfg, plan=pipe.target._serve_handle(
                                plan, LM_COMPRESS_K), device="cuda")
    with _MoEAux() as aux1:
        ref = {r.rid: r for r in oneshot.serve(requests)}
    same = sum(a == b for rid, r in engine.items()
               for a, b in zip(r.tokens, ref[rid].tokens))
    total = sum(len(r.tokens) for r in engine.values())
    m = plan.metrics
    out = dict(serve=serve, stage_wall_s=wall, forward_calls=dict(calls),
               launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               engine_vs_oneshot_tokens_equal=same,
               engine_vs_oneshot_tokens=total,
               engine_vs_oneshot_agreement=same / max(total, 1),
               dropped_frac_engine_mean=sum(aux.dropped)
               / max(len(aux.dropped), 1),
               dropped_frac_engine_max=max(aux.dropped, default=0.0),
               dropped_frac_oneshot_mean=sum(aux1.dropped)
               / max(len(aux1.dropped), 1),
               **{k[len("serve_"):]: v for k, v in m.items()
                  if k.startswith("serve_") and k[len("serve_"):] in (
                      "requests", "new_tokens", "wall_s", "tokens_per_s",
                      "ttft_p50_s", "ttft_p99_s", "latency_p50_s",
                      "latency_p99_s", "slot_utilization",
                      "recompiles_after_warmup")})
    print(f"[{tag}] serve stage " + json.dumps(out, sort_keys=True),
          flush=True)
    del oneshot, pipe
    torch.cuda.empty_cache()
    if out["recompiles_after_warmup"] != 0:
        raise AssertionError(f"[{tag}] {out['recompiles_after_warmup']} "
                             "builds after warmup")
    if launches != {"K2": 0, "K3": forwards} or not forwards:
        raise AssertionError(f"[{tag}] serve stage launches {launches}, "
                             f"expected one K3 launch a forward call "
                             f"({forwards}) and no K2")
    return out


def lm_moe_phase(torch, ops, ref):
    """[lm-moe]: `MoETarget` on phi3.5-moe-42b-a6.6b at its published width
    (all 16 experts, top-2) and MOE_LAYERS of its 32 layers, seeded (init
    on the host, moved to the card): ``Pipeline(cfg, device="cuda")``
    through export (calibration on the card; each expert's k from the
    ladder by its traffic rank within its layer; MOE_LAYERS x 52 matmuls,
    LUT parity over each), the routed gates, K2 at the expert shapes (M =
    160 and 32), K3's one launch with the per-expert entries bit for bit,
    served (52 K2 launches a layer a forward) against fake-quant (one K3)
    prefill of 4 x 256 tokens and 8 decode steps at float32 (< 2e-2; the
    witness on shared activation codes), each MoE call's dropped
    fraction, the serve stage's engine (`moe_engine_stage`), and card vs
    CPU dispatch at depth MOE_CHECK_LAYERS (`moe_dispatch_check`).
    Returns (metrics, K2 rows, K3 metrics)."""
    from repro_torch._device import tree_to
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.nn.spec import init_params
    from repro_torch.pipeline.pipeline import Pipeline

    t_phase = time.perf_counter()
    tag = "lm-moe"
    with _Depth(MOE_ARCH, MOE_LAYERS):
        cfg = routed_config("moe", MOE_ARCH)
        pipe = Pipeline(cfg, device="cuda")
        t0 = time.perf_counter()
        params_host = init_params(cfg.target.seed, pipe.target.model.spec,
                                  "cpu")
        pipe.plan.params = tree_to(params_host, "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_units = MOE_UNITS_A_LAYER * MOE_LAYERS
        n_exp = pipe.target.acfg.n_experts
        target, plan, metrics = lm_export_path(torch, MOE_ARCH, n_units,
                                               tag, pipe=pipe)
        routed = routed_gates(plan, tag, 3 * n_exp * MOE_LAYERS,
                              per_layer=True)
        k2_rows = k2_phase(torch, ops, ref, moe_k2_cases(torch, target.acfg),
                           LM_RECURRENT_K2_REPS)
        k3_out = moe_k3_phase(torch, target.model, plan)
        torch.cuda.empty_cache()
        comp_serve, n = lm_attached(torch, target, plan, tag)
        k2.launches = k3.launches = 0
        with _MoEAux() as aux:
            serve = lm_serve_phase(torch, target, plan, comp_serve,
                                   "float32", f"{tag}-serve",
                                   shared_codes=True)
        serve_launches = {"K2": k2.launches, "K3": k3.launches}
        serve["dropped_frac_prefill"] = aux.dropped[:MOE_LAYERS]
        serve["dropped_frac_decode_max"] = max(
            aux.dropped[MOE_LAYERS:(1 + LM_DECODE_STEPS) * MOE_LAYERS])
        print(f"[{tag}-serve] dropped_frac: prefill "
              f"{serve['dropped_frac_prefill']}, decode max "
              f"{serve['dropped_frac_decode_max']}", flush=True)
        del comp_serve
        torch.cuda.empty_cache()
        engine = moe_engine_stage(torch, target, plan, tag)
        dispatch = moe_dispatch_check(torch, target.model, params_host,
                                      plan.params, tag)
    metrics.update(layers=MOE_LAYERS, init_s=init_s, routed=routed,
                   stacked_units_attached=n, serve=serve, engine=engine,
                   dispatch=dispatch, serve_path_launches=serve_launches,
                   phase_wall_s=time.perf_counter() - t_phase,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[{tag}] " + json.dumps({k: v for k, v in metrics.items()
                                    if k not in ("serve", "engine")},
                                   sort_keys=True), flush=True)
    print(f"[{tag}] phase {metrics['phase_wall_s']:.1f} s", flush=True)
    del plan, target, pipe, params_host
    torch.cuda.empty_cache()
    return metrics, k2_rows, k3_out


# ------------------------------------------------------------ Table 1


def table1_phase(torch):
    """[table1]: the paper's Table 1 for ResNet-20 on the card, through the
    port's `core.baselines` and schedule (`T1_*`): origin (QAT, 256
    values), the PowerPruning-style global selection (32 values, 50%
    pruning, 40 fine-tune steps) and ours (`energy_prioritized_compression`
    with the script's configs), each from the same trained and profiled
    state. Gates the structure, not the savings' size: the PowerPruning
    codebook has 32 values and every layer carries it, every mask removes
    half its weights (to one weight), energies are finite and positive and
    fall, and K1 (the profile) and K3 (the QAT fine-tunes, the schedule)
    launched. The QAT steps, the baselines and the schedule are functional
    (new tensors and comp dicts), so each row starts from the same state."""
    from repro_torch.core import baselines
    from repro_torch.core.runner import CnnRunner
    from repro_torch.core.schedule import energy_prioritized_compression
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.transition_energy import transition_energy as k1
    from repro_torch.nn.cnn import resnet20
    from repro_torch.pipeline.config import ScheduleConfig, SelectionConfig

    t_phase = time.perf_counter()
    before = {"K1": k1.launches, "K3": k3.launches}
    k1.launches = k3.launches = 0
    runner = CnnRunner(resnet20(10), SyntheticImages(num_classes=10,
                                                     seed=T1_DATA_SEED),
                       batch_size=T1_BATCH, lr=T1_LR, seed=0, device="cuda")
    t0 = time.perf_counter()
    p, s, o, c = runner.init()
    p, s, o, loss = runner.train(p, s, o, c, T1_QAT_STEPS)
    acc0 = runner.accuracy(p, s, c, n_batches=4)
    stats = runner.profile(p, s, c, n_batches=1, max_tiles=8)
    torch.cuda.synchronize()
    rows = [dict(method="origin", accuracy=acc0, energy_saving=0.0,
                 selected_weights=256, qat_loss=loss,
                 wall_s=time.perf_counter() - t0)]

    t0 = time.perf_counter()
    *_, pp_comp, pp = baselines.powerpruning_global(runner, p, s, o, c, stats,
                                                    **T1_PP)
    torch.cuda.synchronize()
    rows.append(dict(method="powerpruning[15](32)", accuracy=pp.acc_after,
                     energy_saving=pp.energy_saving,
                     selected_weights=len(pp.codebook),
                     energy_before=pp.energy_before,
                     energy_after=pp.energy_after,
                     wall_s=time.perf_counter() - t0))
    t0 = time.perf_counter()
    *_, ours_comp, res = energy_prioritized_compression(
        runner, p, s, o, c, stats, ScheduleConfig(**T1_SCHEDULE),
        SelectionConfig(**T1_SELECTION))
    torch.cuda.synchronize()
    rows.append(dict(method="ours(16)", accuracy=res.acc_final,
                     energy_saving=res.energy_saving, selected_weights=16,
                     accepted_layers=sum(d.accepted for d in res.decisions),
                     energy_before=res.energy_before,
                     energy_after=res.energy_after,
                     wall_s=time.perf_counter() - t0))
    launches = {"K1": k1.launches, "K3": k3.launches}
    out = dict(network="ResNet-20-c10", rows=rows, launches=launches,
               ours_beats_pp=res.energy_saving > pp.energy_saving,
               pp_codebook=pp.codebook,
               phase_wall_s=time.perf_counter() - t_phase)
    for r in rows:
        print(f"[table1] {r['method']:<22} accuracy {r['accuracy']:.4f} "
              f"energy saving {r['energy_saving']:.4f} selected weights "
              f"{r['selected_weights']} wall {r['wall_s']:.1f} s",
              flush=True)
    print("[table1] " + json.dumps(out, sort_keys=True), flush=True)

    problems = []
    if len(set(pp.codebook)) != 32:
        problems.append(f"PowerPruning codebook of {len(set(pp.codebook))} "
                        "values")
    for name, comp in pp_comp.items():
        if int(comp["codebook_k"]) != 32 or \
                comp["codebook"][:32].tolist() != pp.codebook:
            problems.append(f"{name} does not carry the global codebook")
        n, zeros = comp["mask"].numel(), int((comp["mask"] == 0).sum())
        if abs(zeros - round(0.5 * n)) > 1:
            problems.append(f"{name}: mask removes {zeros} of {n}")
    for label, e0, e1 in (("powerpruning", pp.energy_before,
                           pp.energy_after),
                          ("ours", res.energy_before, res.energy_after)):
        if not (np.isfinite([e0, e1]).all() and e0 > 0 and e1 > 0
                and e1 <= e0):
            problems.append(f"{label} energies {e0} -> {e1}")
    if not (launches["K1"] > 0 and launches["K3"] > 0):
        problems.append(f"launches {launches}")
    if problems:
        raise AssertionError("[table1] " + "; ".join(problems))
    k1.launches += before["K1"]
    k3.launches += before["K3"]
    del runner, pp_comp, ours_comp
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ LM encdec


def encdec_k2_cases(torch, acfg):
    """`k2_phase` cases of whisper's (K, N) pairs (d x d: the attention
    and cross-attention projections; d x d_ff with the gelu epilogue;
    d_ff x d) at the encoder's M (requests x frames), the decoder
    prefill's (requests x prompt) and decode's (requests), float32 X."""
    d, f = acfg.d_model, acfg.d_ff
    shapes = [("qkvo", d, d, "none"), ("up", d, f, "gelu"),
              ("down", f, d, "none")]
    cases = []
    for step, m in (("encoder", ENCDEC_REQUESTS * ENCDEC_FRAMES),
                    ("prefill", ENCDEC_REQUESTS * ENCDEC_PROMPT_LEN),
                    ("decode", ENCDEC_REQUESTS)):
        for name, k, n, act in shapes:
            cases.append((f"whisper {step} {name}", m, k, k, n, act, False,
                          False, torch.float32, 0, True))
    return cases


def encdec_inputs(torch, vocab, d_model, seed=LM_PROMPT_SEED):
    """Seeded stub frames (requests, frames, d) and prompts plus the fed
    decode tokens (requests, prompt + steps), on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randn((ENCDEC_REQUESTS, ENCDEC_FRAMES, d_model),
                         generator=gen, device="cuda")
    toks = torch.randint(0, vocab, (ENCDEC_REQUESTS,
                                    ENCDEC_PROMPT_LEN + LM_DECODE_STEPS),
                         generator=gen, device="cuda", dtype=torch.int32)
    return frames, toks


def encdec_serve(torch, model, plan, comp_serve, frames, toks):
    """Served (K2) against fake-quant (K3) prefill of the requests and
    LM_DECODE_STEPS decode steps (both fed the same tokens), float32; each
    path once to warm up, then timed. Launches: a served prefill one K2
    launch an exported matmul, a served decode step 8 a decoder layer (the
    cross-attention's wk/wv are read from the cache), no K3; a fake-quant
    forward one K3 launch (the encoder's units join the decoder's), no
    K2. `lm_witness` (the fake-quant forward on the artifacts' dequantized
    weights) tells the served plumbing from the straight-through rounding;
    run on the served run's int8 activation codes (`_ActQuant` replay) it
    also takes out the activation codes that K2's gelu epilogue, a float32
    ulp off torch's, moved (reported: ``flipped_codes``). Gated: the
    launches, finite logits, prefill logit rel err < SERVE_PARITY, that
    witness's logits within WITNESS_PARITY of the served ones; the witness
    on its own codes is reported."""
    from repro_torch.nn.layers import QuantConfig

    vocab = model.cfg.vocab
    prompts, feed = toks[:, :ENCDEC_PROMPT_LEN], toks[:, ENCDEC_PROMPT_LEN:]
    runs = {}
    for label, qcfg, comp in (("served", QuantConfig.serve(), comp_serve),
                              ("fake_quant", QuantConfig.on(), plan.comp)):
        args = (torch, model, plan.params, comp, qcfg, prompts,
                torch.float32, feed, frames, ENCDEC_MAX_LEN)
        lm_generate(*args)
        runs[label] = lm_generate(*args)
        torch.cuda.empty_cache()
    n_dec = model.cfg.n_layers
    want = {"served": ({"K2": len(plan.artifacts), "K3": 0},
                       {"K2": 8 * n_dec, "K3": 0}),
            "fake_quant": ({"K2": 0, "K3": 1}, {"K2": 0, "K3": 1})}
    for label, run in runs.items():
        checks = [("prefill", run[5], want[label][0])] + [
            (f"decode step {i}", c, want[label][1])
            for i, c in enumerate(run[6])]
        for where, got, expect in checks:
            if got != expect:
                raise AssertionError(f"[lm-encdec] {label} {where}: "
                                     f"launches {got}, expected {expect}")
        if not torch.isfinite(run[0][..., :vocab]).all() or tuple(
                run[0].shape) != (ENCDEC_REQUESTS, ENCDEC_PROMPT_LEN,
                                  model.cfg.padded_vocab):
            raise AssertionError(f"[lm-encdec] {label}: bad prefill logits")
    srv, fq = runs["served"], runs["fake_quant"]
    out = dict(prefill_logit_rel_err=lm_rel(torch, srv[0], fq[0], vocab),
               decode_logit_rel_err=[lm_rel(torch, a, b, vocab)
                                     for a, b in zip(srv[1], fq[1])],
               greedy_token_agreement=[
                   float((a[..., :vocab].argmax(-1)
                          == b[..., :vocab].argmax(-1)).float().mean())
                   for a, b in zip(srv[1], fq[1])],
               launches_prefill={k: r[5] for k, r in runs.items()},
               launches_decode_step={k: r[6][0] for k, r in runs.items()})
    out["witness"] = lm_witness(torch, model, plan, prompts, torch.float32,
                                srv[2], srv, frames, ENCDEC_MAX_LEN)
    # the witness again on the served run's int8 activation codes: K2's
    # gelu epilogue differs from torch's by float32 ulps (the card's
    # tanhf), which can move an activation across a rounding boundary
    with _ActQuant(device="cuda") as record:
        lm_generate(torch, model, plan.params, comp_serve,
                    QuantConfig.serve(), prompts, torch.float32, feed,
                    frames, ENCDEC_MAX_LEN)
    with _ActQuant(replay=record) as replayed:
        shared = lm_witness(torch, model, plan, prompts, torch.float32,
                            srv[2], srv, frames, ENCDEC_MAX_LEN)
    out["witness_on_served_codes"] = dict(
        shared, flipped_codes=replayed.flips,
        codes=sum(c.numel() for c in record.codes))
    del record
    torch.cuda.empty_cache()
    for label, run in runs.items():
        out[f"{label}_prefill_s"] = run[3]
        out[f"{label}_prefill_tokens_per_s"] = (
            ENCDEC_REQUESTS * ENCDEC_PROMPT_LEN / run[3])
        out[f"{label}_prefill_frames_per_s"] = (
            ENCDEC_REQUESTS * ENCDEC_FRAMES / run[3])
        out[f"{label}_decode_ms_per_step"] = [1e3 * t for t in run[4]]
        out[f"{label}_decode_ms_per_step_median"] = 1e3 * statistics.median(
            run[4])
    print("[lm-encdec-serve] " + json.dumps(out, sort_keys=True), flush=True)
    if not out["prefill_logit_rel_err"] < SERVE_PARITY:
        raise AssertionError(f"[lm-encdec] float32 prefill logit rel err "
                             f"{out['prefill_logit_rel_err']:.3e} >= "
                             f"{SERVE_PARITY}")
    wit = out["witness_on_served_codes"]
    worst = max([wit["prefill_logit_rel_err"]] + wit["decode_logit_rel_err"])
    if not worst < WITNESS_PARITY:
        raise AssertionError(f"[lm-encdec] witness on the served codes vs "
                             f"served logit rel err {worst:.3e} >= "
                             f"{WITNESS_PARITY}")
    del runs, srv, fq
    torch.cuda.empty_cache()
    return out


def encdec_roundtrip(torch, model, params, frames, toks):
    """JAX's roundtrip contract at full width, float32, no QAT: prefill the
    prompts over the frames, decode the fed tokens, each position's logits
    against the full forward; with ENCDEC_BLOCK-wide blocks (gated <
    ENCDEC_ROUNDTRIP_ATOL) and with the default 512 (reported: the
    forward's cross-attention also takes the 36 padded keys)."""
    vocab = model.cfg.vocab
    out = {}
    with torch.no_grad():
        for label, blk in (("blocks_%d" % ENCDEC_BLOCK, ENCDEC_BLOCK),
                           ("blocks_512", 512)):
            kw = dict(q_block=blk, kv_block=blk)
            full = model.forward(params, toks, enc_embeds=frames,
                                 **kw)[0][..., :vocab]
            lg, cache = model.prefill(params, toks[:, :ENCDEC_PROMPT_LEN],
                                      ENCDEC_MAX_LEN, enc_embeds=frames,
                                      cache_dtype=torch.float32, **kw)
            errs = [float((lg[..., :vocab]
                           - full[:, :ENCDEC_PROMPT_LEN]).abs().max())]
            for t in range(ENCDEC_PROMPT_LEN, toks.shape[1]):
                lg, cache = model.decode_step(params, cache,
                                              toks[:, t:t + 1])
                errs.append(float((lg[:, 0, :vocab] - full[:, t]).abs()
                                  .max()))
            out[label] = dict(prefill_max_abs_err=errs[0],
                              decode_max_abs_err=errs[1:],
                              max_abs_err=max(errs),
                              logit_max_abs=float(full.abs().max()))
            del full, lg, cache
            torch.cuda.empty_cache()
    print("[lm-encdec] roundtrip " + json.dumps(out, sort_keys=True),
          flush=True)
    gated = out["blocks_%d" % ENCDEC_BLOCK]["max_abs_err"]
    if not gated <= ENCDEC_ROUNDTRIP_ATOL:
        raise AssertionError(f"[lm-encdec] prefill + decode vs the full "
                             f"forward max abs err {gated:.3e} > "
                             f"{ENCDEC_ROUNDTRIP_ATOL}")
    return out


def encdec_train(torch, model, params, comp):
    """`make_train_step` QAT steps (remat, the step's default blocks) at
    batch 1 x (ENCDEC_FRAMES frames, WHISPER_DECODER_LEN tokens) on the
    plan's k = 4 comp, at the config's compute dtype: each step's ms and
    loss, the peak memory, K3 launches (one a step's forward)."""
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.launch import train

    gen = torch.Generator(device="cuda").manual_seed(LM_PROMPT_SEED + 2)
    s_dec = train.WHISPER_DECODER_LEN
    toks = torch.randint(0, model.cfg.vocab, (1, s_dec + 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "enc_embeds": torch.randn((1, ENCDEC_FRAMES, model.cfg.d_model),
                                       generator=gen, device="cuda")}
    cfg = train.StepConfig(qat=True, with_comp=True, remat=True)
    step = train.make_train_step(model, cfg)
    state = {"params": params, "opt": train.make_optimizer(cfg).init(params)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launched = k3.launches
    losses, ms = [], []
    for _ in range(ENCDEC_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, met = step(state, batch, comp)
        losses.append(float(met["loss"]))
        ms.append(1e3 * (time.perf_counter() - t0))
    out = dict(batch=[1, ENCDEC_FRAMES, s_dec], step_ms=ms, losses=losses,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               k3_launches=k3.launches - launched,
               compute_dtype=str(model.cfg.cdtype).replace("torch.", ""))
    print("[lm-encdec-train] " + json.dumps(out, sort_keys=True), flush=True)
    if not all(np.isfinite(losses)) or out["k3_launches"] != len(losses):
        raise AssertionError(f"[lm-encdec-train] losses {losses}, "
                             f"{out['k3_launches']} K3 launches")
    del state, step
    torch.cuda.empty_cache()
    return out


def lm_encdec_phase(torch, ops, ref):
    """[lm-encdec]: whisper-large-v3 at its published width and depth. The
    pipeline through export (`lm_export_path`: ENCDEC_UNITS matmuls, LUT
    parity over each), K2 at whisper's shapes, K3's one grouped launch
    over the encoder's and the decoder's stacked units bit for bit, the
    attached artifacts held to the exported ones, served vs fake-quant
    (`encdec_serve`), the roundtrip (`encdec_roundtrip`) and QAT steps
    (`encdec_train`). Returns (metrics, K2 rows, K3 row)."""
    import dataclasses

    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.models.lm import build_lm

    t_phase = time.perf_counter()
    tag = "lm-encdec"
    target, plan, metrics = lm_export_path(torch, ENCDEC_ARCH, ENCDEC_UNITS,
                                           tag)
    k2_rows = k2_phase(torch, ops, ref, encdec_k2_cases(torch, target.acfg),
                       LM_RECURRENT_K2_REPS)
    k3_row = lm_k3_phase(torch, target.model, plan.params, plan.comp,
                         ("blocks", "enc_blocks"), f"{tag}-k3")
    torch.cuda.empty_cache()
    comp_serve, n = lm_attached(torch, target, plan, tag)
    model = build_lm(dataclasses.replace(target.acfg,
                                         compute_dtype="float32"))
    frames, toks = encdec_inputs(torch, model.cfg.vocab, model.cfg.d_model)
    launched = {"K2": k2.launches, "K3": k3.launches}
    k2.launches = k3.launches = 0
    serve = encdec_serve(torch, model, plan, comp_serve, frames, toks)
    serve_launches = {"K2": k2.launches, "K3": k3.launches}
    del comp_serve
    torch.cuda.empty_cache()
    roundtrip = encdec_roundtrip(torch, model, plan.params, frames, toks)
    k2.launches = k3.launches = 0
    trained = encdec_train(torch, target.model, plan.params, plan.comp)
    k2.launches = launched["K2"] + serve_launches["K2"]
    k3.launches = (launched["K3"] + serve_launches["K3"]
                   + trained["k3_launches"])
    metrics.update(stacked_units_attached=n, serve=serve,
                   roundtrip=roundtrip, train=trained,
                   serve_path_launches=serve_launches,
                   phase_wall_s=time.perf_counter() - t_phase)
    print(f"[{tag}] " + json.dumps({k: v for k, v in metrics.items()
                                    if k not in ("serve", "roundtrip",
                                                 "train")},
                                   sort_keys=True), flush=True)
    print(f"[{tag}] phase {metrics['phase_wall_s']:.1f} s; prefill "
          f"{serve['served_prefill_tokens_per_s']:.0f} tokens/s "
          f"({serve['served_prefill_frames_per_s']:.0f} frames/s), decode "
          f"{serve['served_decode_ms_per_step_median']:.2f} ms a step",
          flush=True)
    del plan, target, model, frames, toks
    torch.cuda.empty_cache()
    return metrics, k2_rows, k3_row


# ------------------------------------------------------------ the VLM prefix


def vlm_k2_cases(torch, acfg):
    """`k2_phase` cases of internvl2's (K, N) pairs (d x d: wq, wo; d x the
    KV width: wk, wv; d x d_ff with the gate's SiLU: w_gate, w_up; d_ff x
    d: w_down) at a served prefill's M (prompts x (patches + tokens)) and
    a decode step's (prompts), float32 X."""
    d, f = acfg.d_model, acfg.d_ff
    kv = acfg.n_kv_heads * acfg.resolved_head_dim
    shapes = [("qo", d, d, "none"), ("kv", d, kv, "none"),
              ("gate/up", d, f, "silu"), ("down", f, d, "none")]
    cases = []
    for step, m in (("prefill", LM_PROMPTS * (acfg.prefix_len
                                              + LM_PROMPT_LEN)),
                    ("decode", LM_PROMPTS)):
        for name, k, n, act in shapes:
            cases.append((f"internvl2 {step} {name}", m, k, k, n, act, False,
                          False, torch.float32, 0, True))
    return cases


def vlm_inputs(torch, acfg, seed=LM_PROMPT_SEED):
    """The stub frontend's patch embeddings (prompts, prefix_len, d),
    float32 from ``np.random.default_rng(seed)`` (as whisper's frames are
    drawn), and the prompts with the fed decode tokens (prompts, prompt
    length + steps), on the card."""
    rng = np.random.default_rng(seed)
    prefix = rng.standard_normal((LM_PROMPTS, acfg.prefix_len,
                                  acfg.d_model), dtype=np.float32)
    toks = rng.integers(0, acfg.vocab, (LM_PROMPTS,
                                        LM_PROMPT_LEN + LM_DECODE_STEPS))
    return (torch.from_numpy(prefix).cuda(),
            torch.from_numpy(toks.astype(np.int32)).cuda())


def vlm_serve(torch, model, plan, comp_serve, prefix, toks):
    """Served (K2) against fake-quant (K3) prefill of the prompts after
    their patch embeddings, then LM_DECODE_STEPS decode steps fed the same
    tokens, float32; each path once to warm up, then timed. Launches: a
    served prefill or decode step one K2 launch an exported matmul (7 a
    layer) and no K3; a fake-quant one one K3 launch and no K2. Gated: the
    launches, finite logits over every position, the prefill and decode
    logits on each run's own activation codes < SERVE_PARITY, and on the
    served run's int8 codes (`_ActQuant` replay, queue 3's rule) the
    fake-quant forward and `lm_witness` < WITNESS_PARITY."""
    from repro_torch.nn.layers import QuantConfig

    vocab = model.cfg.vocab
    prompts, feed = toks[:, :LM_PROMPT_LEN], toks[:, LM_PROMPT_LEN:]
    n_units = len(plan.artifacts)
    gen = dict(feed=feed, max_len=VLM_MAX_LEN, prefix_embeds=prefix)
    runs = {}
    for label, qcfg, comp in (("served", QuantConfig.serve(), comp_serve),
                              ("fake_quant", QuantConfig.on(), plan.comp)):
        args = (torch, model, plan.params, comp, qcfg, prompts,
                torch.float32)
        lm_generate(*args, **gen)
        runs[label] = lm_generate(*args, **gen)
        torch.cuda.empty_cache()
    want = {"served": {"K2": n_units, "K3": 0},
            "fake_quant": {"K2": 0, "K3": 1}}
    positions = model.cfg.prefix_len + LM_PROMPT_LEN
    for label, run in runs.items():
        for where, got in [("prefill", run[5])] + [
                (f"decode step {i}", c) for i, c in enumerate(run[6])]:
            if got != want[label]:
                raise AssertionError(f"[lm-vlm] {label} {where}: launches "
                                     f"{got}, expected {want[label]}")
        if tuple(run[0].shape) != (LM_PROMPTS, positions,
                                   model.cfg.padded_vocab) or not \
                torch.isfinite(run[0][..., :vocab]).all():
            raise AssertionError(f"[lm-vlm] {label}: bad prefill logits "
                                 f"{tuple(run[0].shape)}")
    srv, fq = runs["served"], runs["fake_quant"]
    out = dict(prefill_logit_rel_err=lm_rel(torch, srv[0], fq[0], vocab),
               decode_logit_rel_err=[lm_rel(torch, a, b, vocab)
                                     for a, b in zip(srv[1], fq[1])],
               greedy_token_agreement=[
                   float((a[..., :vocab].argmax(-1)
                          == b[..., :vocab].argmax(-1)).float().mean())
                   for a, b in zip(srv[1], fq[1])],
               launches_prefill={k: r[5] for k, r in runs.items()},
               launches_decode_step={k: r[6][0] for k, r in runs.items()})
    out["witness"] = lm_witness(torch, model, plan, prompts, torch.float32,
                                srv[2], srv, max_len=VLM_MAX_LEN,
                                prefix_embeds=prefix)
    with _ActQuant(device="cuda") as record:
        lm_generate(torch, model, plan.params, comp_serve,
                    QuantConfig.serve(), prompts, torch.float32, **gen)
    codes = sum(c.numel() for c in record.codes)
    with _ActQuant(replay=record) as replayed:
        shared = lm_witness(torch, model, plan, prompts, torch.float32,
                            srv[2], srv, max_len=VLM_MAX_LEN,
                            prefix_embeds=prefix)
    out["witness_on_served_codes"] = dict(
        shared, flipped_codes=replayed.flips, codes=codes)
    with _ActQuant(replay=record) as replayed:
        fq_shared = lm_generate(torch, model, plan.params, plan.comp,
                                QuantConfig.on(), prompts, torch.float32,
                                **gen)
    out["fake_quant_on_served_codes"] = dict(
        prefill_logit_rel_err=lm_rel(torch, srv[0], fq_shared[0], vocab),
        decode_logit_rel_err=[lm_rel(torch, a, b, vocab)
                              for a, b in zip(srv[1], fq_shared[1])],
        flipped_codes=replayed.flips, codes=codes)
    del record, fq_shared
    torch.cuda.empty_cache()
    for label, run in runs.items():
        out[f"{label}_prefill_s"] = run[3]
        out[f"{label}_prefill_positions_per_s"] = (LM_PROMPTS * positions
                                                   / run[3])
        out[f"{label}_decode_ms_per_step"] = [1e3 * t for t in run[4]]
        out[f"{label}_decode_ms_per_step_median"] = 1e3 * statistics.median(
            run[4])
    print("[lm-vlm-serve] " + json.dumps(out, sort_keys=True), flush=True)
    own = max([out["prefill_logit_rel_err"]] + out["decode_logit_rel_err"])
    if not own < SERVE_PARITY:
        raise AssertionError(f"[lm-vlm] served vs fake-quant float32 logit "
                             f"rel err {own:.3e} >= {SERVE_PARITY}")
    for key in ("witness_on_served_codes", "fake_quant_on_served_codes"):
        worst = max([out[key]["prefill_logit_rel_err"]]
                    + out[key]["decode_logit_rel_err"])
        if not worst < WITNESS_PARITY:
            raise AssertionError(f"[lm-vlm] {key} vs served logit rel err "
                                 f"{worst:.3e} >= {WITNESS_PARITY}")
    del runs, srv, fq
    torch.cuda.empty_cache()
    return out


def vlm_roundtrip(torch, model, params, prefix, toks):
    """JAX's roundtrip contract after a prefix, float32, no QAT: prefill
    the patches and prompts (blocks of 256, a divisor of the 512
    positions), decode the fed tokens, each position's logits against the
    full forward over patches + prompts + fed tokens (blocks of 260, a
    divisor of its 520), gated at ROUNDTRIP_ATOL; then the token
    positions' logits of that forward against the same tokens' forward
    without the prefix, which must differ (rel > VLM_PREFIX_MATTERS)."""
    vocab = model.cfg.vocab
    p = model.cfg.prefix_len
    s_all = p + toks.shape[1]
    with torch.no_grad():
        full = model.forward(params, toks, prefix_embeds=prefix,
                             q_block=s_all // 2,
                             kv_block=s_all // 2)[0][..., :vocab]
        s_pre = p + LM_PROMPT_LEN
        lg, cache = model.prefill(params, toks[:, :LM_PROMPT_LEN],
                                  VLM_MAX_LEN, prefix_embeds=prefix,
                                  cache_dtype=torch.float32,
                                  q_block=s_pre // 2, kv_block=s_pre // 2)
        errs = [float((lg[..., :vocab] - full[:, :s_pre]).abs().max())]
        pos = int(cache["pos"][0])
        for t in range(LM_PROMPT_LEN, toks.shape[1]):
            lg, cache = model.decode_step(params, cache, toks[:, t:t + 1])
            errs.append(float((lg[:, 0, :vocab] - full[:, p + t]).abs()
                              .max()))
        del lg, cache
        alone = model.forward(params, toks)[0][..., :vocab]
        matters = lm_rel(torch, full[:, p:], alone, vocab)
    out = dict(prefill_max_abs_err=errs[0], decode_max_abs_err=errs[1:],
               max_abs_err=max(errs), logit_max_abs=float(full.abs().max()),
               cache_pos_after_prefill=pos,
               prefix_vs_none_token_logit_rel=matters)
    print("[lm-vlm] roundtrip " + json.dumps(out, sort_keys=True),
          flush=True)
    del full, alone
    torch.cuda.empty_cache()
    if pos != s_pre:
        raise AssertionError(f"[lm-vlm] prefill cache at pos {pos}, "
                             f"expected {s_pre}")
    if not out["max_abs_err"] < ROUNDTRIP_ATOL:
        raise AssertionError(f"[lm-vlm] prefill + decode vs the full "
                             f"forward max abs err {out['max_abs_err']:.3e} "
                             f">= {ROUNDTRIP_ATOL}")
    if not matters > VLM_PREFIX_MATTERS:
        raise AssertionError(f"[lm-vlm] the prefix moves the token logits "
                             f"by rel {matters:.3e} only")
    return out


def vlm_train(torch, acfg, params, comp):
    """One `make_train_step` QAT step at VLM_TRAIN_LAYERS of the model's
    layers (the first ones of ``params`` and ``comp``, copied), at the
    config's compute dtype, on a batch of 1 x (prefix_len patches,
    VLM_TRAIN_TOKENS tokens) with ``prefix_embeds``: the step's ms and
    loss, the peak memory, K3 launches (one a step's forward)."""
    import dataclasses

    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.launch import train
    from repro_torch.models.lm import build_lm
    from repro_torch.nn.spec import spec_count

    model = build_lm(dataclasses.replace(acfg, n_layers=VLM_TRAIN_LAYERS))
    rng = np.random.default_rng(LM_PROMPT_SEED + 2)
    toks = torch.from_numpy(rng.integers(
        0, acfg.vocab, (1, VLM_TRAIN_TOKENS + 1)).astype(np.int32)).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "prefix_embeds": torch.from_numpy(rng.standard_normal(
                 (1, acfg.prefix_len, acfg.d_model),
                 dtype=np.float32)).cuda()}
    cfg = train.StepConfig(qat=True, with_comp=True, remat=False)
    step = train.make_train_step(model, cfg)
    state = {"params": params, "opt": train.make_optimizer(cfg).init(params)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launched = k3.launches
    t0 = time.perf_counter()
    state, met = step(state, batch, comp)
    loss = float(met["loss"])
    ms = 1e3 * (time.perf_counter() - t0)
    out = dict(layers=VLM_TRAIN_LAYERS, n_params=spec_count(model.spec),
               batch=[1, acfg.prefix_len, VLM_TRAIN_TOKENS], step_ms=ms,
               loss=loss, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               k3_launches=k3.launches - launched,
               compute_dtype=str(model.cfg.cdtype).replace("torch.", ""))
    print("[lm-vlm-train] " + json.dumps(out, sort_keys=True), flush=True)
    if not np.isfinite(loss) or out["k3_launches"] != 1:
        raise AssertionError(f"[lm-vlm-train] loss {loss}, "
                             f"{out['k3_launches']} K3 launches")
    del state, step
    torch.cuda.empty_cache()
    return out


def lm_vlm_phase(torch, ops, ref):
    """[lm-vlm]: internvl2-26b at its published width and VLM_LAYERS of its
    48 layers (`_Depth`), seeded. The pipeline through export
    (`lm_export_path`: 7 matmuls a layer, LUT parity over each), K2 at
    internvl2's shapes at M = 2048 and 4, K3's one grouped launch (7
    entries x VLM_LAYERS layers) bit for bit, the attached artifacts held
    to the exported ones, served vs fake-quant after the patch embeddings
    (`vlm_serve`), the roundtrip and the prefix's effect (`vlm_roundtrip`),
    and one QAT step with ``prefix_embeds`` at VLM_TRAIN_LAYERS layers
    (`vlm_train`). Returns (metrics, K2 rows, K3 row)."""
    import dataclasses

    from repro_torch._device import tree_map
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.models.lm import build_lm
    from repro_torch.pipeline.pipeline import Pipeline

    t_phase = time.perf_counter()
    tag = "lm-vlm"
    torch.cuda.reset_peak_memory_stats()
    with _Depth(VLM_ARCH, VLM_LAYERS):
        pipe = Pipeline(lm_config(VLM_ARCH), device="cuda")
        target, plan, metrics = lm_export_path(
            torch, VLM_ARCH, 7 * VLM_LAYERS, tag, pipe=pipe)
    acfg = target.acfg
    k2_rows = k2_phase(torch, ops, ref, vlm_k2_cases(torch, acfg),
                       LM_RECURRENT_K2_REPS)
    k3_row = lm_k3_phase(torch, target.model, plan.params, plan.comp,
                         tag=f"{tag}-k3")
    torch.cuda.empty_cache()
    comp_serve, n = lm_attached(torch, target, plan, tag)
    model = build_lm(dataclasses.replace(acfg, compute_dtype="float32"))
    prefix, toks = vlm_inputs(torch, acfg)
    launched = {"K2": k2.launches, "K3": k3.launches}
    k2.launches = k3.launches = 0
    serve = vlm_serve(torch, model, plan, comp_serve, prefix, toks)
    serve_launches = {"K2": k2.launches, "K3": k3.launches}
    del comp_serve
    torch.cuda.empty_cache()
    roundtrip = vlm_roundtrip(torch, model, plan.params, prefix, toks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the QAT step's model: the first VLM_TRAIN_LAYERS layers, copied, and
    # the shared embedding, norm and head; the rest of the plan is freed
    params = dict(plan.params, blocks=tree_map(
        lambda x: x[:VLM_TRAIN_LAYERS].clone(), plan.params["blocks"]))
    comp = dict(plan.comp, blocks=tree_map(
        lambda x: x[:VLM_TRAIN_LAYERS].clone(), plan.comp["blocks"]))
    del plan, target, pipe, model, prefix, toks
    torch.cuda.empty_cache()
    k2.launches = launched["K2"] + serve_launches["K2"]
    k3.launches = launched["K3"] + serve_launches["K3"]
    trained = vlm_train(torch, acfg, params, comp)
    del params, comp
    torch.cuda.empty_cache()
    metrics.update(layers=VLM_LAYERS, reduced=dict(
        n_layers=[VLM_LAYERS, 48], train_layers=VLM_TRAIN_LAYERS,
        why="48 layers are 1.986e10 parameters, 79.4 GB in float32"),
        stacked_units_attached=n, serve=serve, roundtrip=roundtrip,
        train=trained, serve_path_launches=serve_launches,
        peak_mem_gb=peak_gb, phase_wall_s=time.perf_counter() - t_phase)
    print(f"[{tag}] " + json.dumps({k: v for k, v in metrics.items()
                                    if k not in ("serve", "roundtrip",
                                                 "train")},
                                   sort_keys=True), flush=True)
    print(f"[{tag}] phase {metrics['phase_wall_s']:.1f} s; prefill "
          f"{serve['served_prefill_positions_per_s']:.0f} positions/s, "
          f"decode {serve['served_decode_ms_per_step_median']:.2f} ms a "
          f"step; peak {peak_gb:.1f} GB", flush=True)
    return metrics, k2_rows, k3_row


# ------------------------------------------------------------ the cosim


def cosim_cases(torch):
    """[(label, w_tiles, a_blocks, mask)]: the K1 phase's own cases (the
    profile path's tile counts, all 12,288 tiles of a ResNet-20 stage-1
    conv, masked tiles, boundary tiles with extreme psums of both signs and
    all-zero psums, one tile), then COSIM_TILES random tiles at each T of
    COSIM_T."""
    from repro_torch.nn.cnn import resnet20

    cases = [(label, w, a, m) for label, w, a, m, _ in
             k1_cases(torch, resnet20().comp_layers)]
    gen = torch.Generator(device="cuda").manual_seed(11)
    for t_len in COSIM_T:
        w = torch.randint(-127, 128, (COSIM_TILES, 64, 64), generator=gen,
                          device="cuda", dtype=torch.int32)
        a = torch.randint(-128, 128, (COSIM_TILES, 64, t_len), generator=gen,
                          device="cuda", dtype=torch.int32)
        cases.append((f"T = {t_len}, {COSIM_TILES} tiles", w, a,
                      torch.ones(COSIM_TILES, device="cuda")))
    return cases


def cosim_profile_config(verify):
    """The [profile] phase's config (ResNet-20, batch 256, no QAT steps,
    PROFILE_TILES tiles a layer) with ``profile.verify_cosim``."""
    from repro_torch.pipeline.config import (
        PipelineConfig,
        ProfileStageConfig,
        TargetConfig,
        TrainStageConfig,
    )

    return PipelineConfig(
        target=TargetConfig(kind="cnn", arch="resnet20", batch_size=BATCH),
        train=TrainStageConfig(qat_steps=0),
        profile=ProfileStageConfig(batches=1, max_tiles=PROFILE_TILES,
                                   verify_cosim=verify))


def cosim_gate(metrics, tiles, tag):
    """The plan's cosim metrics: every bin equal over ``tiles`` tiles."""
    if not (metrics["cosim_match"] is True
            and metrics["cosim_max_abs_diff"] == 0.0
            and metrics["cosim_tiles"] == tiles):
        raise AssertionError(f"[{tag}] cosim metrics {metrics}, expected a "
                             f"match over {tiles} tiles")


def cosim_profile(torch, work):
    """``Pipeline(cfg, device="cuda").run_until("energy_model")`` with
    ``profile.verify_cosim`` on the [profile] phase's setup: 22 K1 launches
    for the statistics and 22 for the check, the cosim metrics over every
    profiled tile; then ``python -m repro_torch profile --config <the same>
    --verify-cosim`` (its entry point, `cli.main`) writes the same metrics
    to its plan. Returns the metrics."""
    from repro_torch.core.stats import TILE
    from repro_torch.kernels.transition_energy import transition_energy as k1
    from repro_torch.pipeline import cli
    from repro_torch.pipeline.pipeline import Pipeline

    cfg = cosim_profile_config(True)
    pipe = Pipeline(cfg, device="cuda")
    k1.launches = 0
    t0 = time.perf_counter()
    plan = pipe.run_until("energy_model", verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.launches
    n_layers = len(pipe.target.model.comp_layers)
    tiles = sum(int(s.n_transitions) for s in plan.stats.values()) \
        // (TILE * TILE * (TILE - 1))
    cosim = {k: v for k, v in plan.metrics.items() if k.startswith("cosim_")}
    out = dict(pipeline=dict(cosim, wall_s=wall, k1_launches=launches,
                             profiled_tiles=tiles,
                             wall_s_profile=plan.metrics["wall_s_profile"]))
    cosim_gate(plan.metrics, tiles, "cosim")
    if launches != 2 * n_layers:
        raise AssertionError(f"[cosim] {launches} K1 launches, expected "
                             f"{n_layers} for the statistics and {n_layers} "
                             "for the check")
    del pipe, plan
    path = work / "cosim_profile.json"
    path.write_text(json.dumps(cosim_profile_config(False).to_dict()))
    k1.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["profile", "--config", str(path), "--verify-cosim",
                   "--device", "cuda", "--quiet", "--plan-out",
                   str(work / "cosim_cli")])
    torch.cuda.synchronize()
    doc = json.loads((work / "cosim_cli.json").read_text())
    out["cli"] = dict({k: v for k, v in doc["metrics"].items()
                       if k.startswith("cosim_")}, rc=rc,
                      k1_launches=k1.launches,
                      command_wall_s=time.perf_counter() - t0,
                      plan_verify_cosim=doc["config"]["profile"][
                          "verify_cosim"])
    print("[cosim] profile " + json.dumps(out, sort_keys=True), flush=True)
    cosim_gate(doc["metrics"], tiles, "cosim cli")
    if rc != 0 or k1.launches != 2 * n_layers:
        raise AssertionError(f"[cosim] cli rc {rc}, {k1.launches} K1 "
                             "launches")
    return out


def cosim_phase(torch, work):
    """[cosim]: the profile path with the cosim gate (`cosim_profile`),
    then K1 against the cosim (`repro_torch.cosim.verify_tiles`) on every
    case of `cosim_cases`: every bin equal, K1's ms a call (CUDA events)
    beside the cosim's seconds (host clock, synchronized). Returns the
    metrics; the check's K1 launches are not the main path's."""
    from repro_torch.core.profiler import batched_layer_counts
    from repro_torch.cosim import verify_tiles
    from repro_torch.kernels.transition_energy import transition_energy as k1

    t_phase = time.perf_counter()
    profile = cosim_profile(torch, work)
    launched = k1.launches
    rows = []
    for label, w, a, m in cosim_cases(torch):
        k1_ms = time_turns(torch, {"k1": lambda: batched_layer_counts(
            w, a, mask=m)}, 3)["k1"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = verify_tiles(w, a, mask=m)
        torch.cuda.synchronize()
        row = dict(case=label, T=int(a.shape[2]), k1_ms=k1_ms,
                   cosim_s=time.perf_counter() - t0,
                   **{k: res[k] for k in ("n_tiles", "n_transitions",
                                          "match", "max_abs_diff",
                                          "kernel_total", "cosim_total",
                                          "toggles", "exactness_ok")})
        rows.append(row)
        print(f"[cosim] {label:<34} T={row['T']:<3} live tiles "
              f"{res['n_tiles']:<6} transitions {res['n_transitions']:.3e} "
              f"match={res['match']} max_abs_diff={res['max_abs_diff']} "
              f"toggles={res['toggles']} K1 {k1_ms:.4f} ms, cosim "
              f"{row['cosim_s']:.3f} s", flush=True)
        if not res["match"] or res["kernel_total"] != res["cosim_total"]:
            raise AssertionError(f"[cosim] {label}: K1 differs from the "
                                 f"cosim ({res})")
        del w, a, m
    k1.launches = launched
    torch.cuda.empty_cache()
    out = dict(profile=profile, cases=rows,
               phase_wall_s=time.perf_counter() - t_phase)
    print(f"[cosim] phase {out['phase_wall_s']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------- main


# ------------------------------------------------ 1-D meshes and faults


def card_mesh(torch, make, n):
    """An ``n``-shard mesh of ``make`` (`tile_mesh`, `sweep_mesh`,
    `request_mesh`), every shard on cuda:0."""
    return make([torch.device("cuda", 0)] * n)


def stats_gap(torch, got, want):
    """(every integer statistic equal, energy sums bit-equal, largest
    relative gap of the energy sums) of two {layer: LayerStats}."""
    ints, exact, gap = True, True, 0.0
    for name, w in want.items():
        g = got[name]
        for f in ("count", "group_hist", "act_hist"):
            ints &= torch.equal(getattr(g, f).cpu(), getattr(w, f).cpu())
        a, b = g.energy_sum.cpu().double(), w.energy_sum.cpu().double()
        exact &= torch.equal(g.energy_sum.cpu(), w.energy_sum.cpu())
        gap = max(gap, float((a - b).abs().max()
                             / torch.clamp(b.abs().max(), min=1e-30)))
    return ints, exact, gap


def mesh_profile(torch, runner, plan):
    """[mesh] profile: the runner's profile stage (ResNet-20, batch 256, the
    [profile] pipeline's runner and plan) with ``profile_mesh`` over 1 and
    MESH_SHARDS shards on cuda:0 against the stage's own statistics, then at
    MESH_PAD_TILES tiles a layer over 3 and MESH_SHARDS shards (padded
    with masked tiles) against the unsharded stage at that count: every
    integer statistic bin for bin, the energy sums bit-equal or within
    MESH_FLOAT_RTOL; K1 launches one a shard a layer. Then all tiles of a
    stage-1 conv over MESH_SHARDS shards against one K1 call, bin for bin,
    both timed between CUDA events. Returns the metrics."""
    from repro_torch.core.profiler import (
        batched_layer_counts,
        gather_layer_tiles,
        sharded_layer_counts,
    )
    from repro_torch.core.stats import pad_to_tiles
    from repro_torch.distributed.sharding import tile_mesh
    from repro_torch.kernels.transition_energy import transition_energy as k1

    n_layers = len(runner.model.comp_layers)

    def stage(shards, tiles):
        runner.profile_mesh = (None if shards is None
                               else card_mesh(torch, tile_mesh, shards))
        k1.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = runner.profile(plan.params, plan.state, plan.comp,
                               n_batches=1, max_tiles=tiles)
        torch.cuda.synchronize()
        return stats, k1.launches, time.perf_counter() - t0

    t_phase = time.perf_counter()
    runs = {}
    base = {PROFILE_TILES: plan.stats}
    base[MESH_PAD_TILES], _, _ = stage(None, MESH_PAD_TILES)
    for shards, tiles in ((1, PROFILE_TILES), (MESH_SHARDS, PROFILE_TILES),
                          (3, MESH_PAD_TILES),
                          (MESH_SHARDS, MESH_PAD_TILES)):
        stats, launches, wall = stage(shards, tiles)
        ints, exact, gap = stats_gap(torch, stats, base[tiles])
        padded = sorted(n for n, s in stats.items()
                        if (s.n_transitions // (64 * 64 * 63)) % shards)
        key = f"{shards}_shards_{tiles}_tiles"
        runs[key] = dict(k1_launches=launches, stage_s=wall,
                         integers_equal=ints, energy_sum_exact=exact,
                         energy_sum_max_rel_gap=gap, padded_layers=padded)
        if launches != shards * n_layers:
            raise AssertionError(f"[mesh] profile {key}: {launches} K1 "
                                 f"launches, expected {shards * n_layers}")
        if not ints or gap > MESH_FLOAT_RTOL:
            raise AssertionError(f"[mesh] profile {key}: sharded statistics "
                                 f"differ from the unsharded stage: "
                                 f"{runs[key]}")
    runner.profile_mesh = None

    cl = next(c for c in runner.model.comp_layers if c.name == "s1b1/conv1")
    tap = runner.capture_taps(plan.params, plan.state, plan.comp, 1)[cl.name]
    w_pad, x_pad = pad_to_tiles(*runner.layer_trace_inputs(cl, tap))
    n_all = (w_pad.shape[0] * w_pad.shape[1] * x_pad.shape[1]) // 64 ** 3
    w_t, a_t = gather_layer_tiles(w_pad, x_pad,
                                  torch.arange(n_all, device="cuda"))
    del tap, w_pad, x_pad
    mesh = card_mesh(torch, tile_mesh, MESH_SHARDS)
    one = batched_layer_counts(w_t, a_t)
    k1.launches = 0
    sharded = sharded_layer_counts(w_t, a_t, mesh=mesh)
    all_launches = k1.launches
    equal = all(torch.equal(a, b) for a, b in zip(one, sharded))
    ms = time_turns(torch, {
        "one_call": lambda: batched_layer_counts(w_t, a_t),
        "sharded": lambda: sharded_layer_counts(w_t, a_t, mesh=mesh)}, 5)
    all_tiles = dict(layer=cl.name, tiles=n_all, shards=MESH_SHARDS,
                     k1_launches=all_launches, bins_equal=equal,
                     one_call_ms=ms["one_call"], sharded_ms=ms["sharded"])
    del w_t, a_t, one, sharded
    if not equal or all_launches != MESH_SHARDS:
        raise AssertionError(f"[mesh] profile all tiles: {all_tiles}")
    out = dict(runs=runs, all_tiles=all_tiles,
               phase_s=time.perf_counter() - t_phase)
    print("[mesh] profile " + json.dumps(out, sort_keys=True), flush=True)
    return out


def fault_runner(torch):
    """(runner, params, state, opt_state, comp) of ResNet-20 QAT at batch
    BATCH on the card: seeded init, `SyntheticImages(seed=7)`, the
    `restricted_comp` tree (K3 through projection, mask and truncation)."""
    from repro_torch.core.runner import CnnRunner
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.nn.cnn import resnet20

    runner = CnnRunner(resnet20(), SyntheticImages(seed=7), batch_size=BATCH,
                       device="cuda")
    params, state, opt_state, _ = runner.init()
    comp = restricted_comp(torch, runner.model, params, "cuda")
    return runner, params, state, opt_state, comp


def fault_loop(torch, work, faults, monitor=None):
    """`run_resilient_loop` over FAULT_STEPS QAT steps of `fault_runner`
    (checkpoint every FAULT_EVERY steps, asynchronous saves), with a fault
    injected before each step in ``faults`` (once each). Returns (final
    state, report, K3 launches, wall s)."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.fault import run_resilient_loop
    from repro_torch.kernels.fake_quant import fake_quant as k3

    runner, params, state, opt_state, comp = fault_runner(torch)
    fired = set()

    def hook(step):
        if step in faults and step not in fired:
            fired.add(step)
            raise RuntimeError(f"injected device failure at step {step}")

    def step_fn(s, batch):
        p, st, o, loss = runner.train_step(s["params"], s["state"], s["opt"],
                                           comp, batch)
        return {"params": p, "state": st, "opt": o}, {"loss": loss}

    path = work / f"fault_{len(faults)}"
    shutil.rmtree(path, ignore_errors=True)
    k3.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, report = run_resilient_loop(
        step_fn=step_fn,
        data_fn=lambda step: runner.dataset.batch(step, BATCH, "train",
                                                  device="cuda"),
        state={"params": params, "state": state, "opt": opt_state},
        ckpt=CheckpointManager(path), n_steps=FAULT_STEPS,
        checkpoint_every=FAULT_EVERY, fault_hook=hook, monitor=monitor,
        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shutil.rmtree(path, ignore_errors=True)
    return final, report, k3.launches, wall


def max_gap(torch, a, b):
    """Largest absolute difference over the matching leaves of two trees."""
    la, lb = leaves(a), leaves(b)
    return max(float((la[n].double() - lb[n].double()).abs().max())
               if la[n].numel() else 0.0 for n in lb)


def fault_compression(torch):
    """FAULT_COMPRESS_STEPS QAT steps with AdamW wrapped in
    ``compressed(..., int8_compressor())``: finite losses, one K3 launch a
    step, the compressor's ``wire_bytes / raw_bytes``; then one step's
    gradients quantized on the card and on the CPU: int8 codes and scales
    equal leaf for leaf."""
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.optim import compression

    runner, params, state, _, comp = fault_runner(torch)
    comp8 = compression.int8_compressor()
    runner.optimizer = compression.compressed(runner.optimizer, comp8)
    opt_state = runner.optimizer.init(params)
    losses = []
    k3.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(FAULT_COMPRESS_STEPS):
        batch = runner.dataset.batch(step, BATCH, "train", device="cuda")
        params, state, opt_state, loss = runner.train_step(
            params, state, opt_state, comp, batch)
        losses.append(float(loss))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k3.launches
    batch = runner.dataset.batch(FAULT_COMPRESS_STEPS, BATCH, "train",
                                 device="cuda")
    _, grads, _ = runner.loss_and_grads(params, state, comp, batch)
    _, _, stats = comp8.compress(grads, opt_state["ef"])
    leaves_equal = codes = 0
    for name, g in leaves(grads).items():
        e = leaves(opt_state["ef"])[name]
        q, scale, _ = compression.int8_codes(g, e)
        q_cpu, scale_cpu, _ = compression.int8_codes(g.cpu(), e.cpu())
        leaves_equal += bool(torch.equal(q.cpu(), q_cpu)
                             and torch.equal(scale.cpu(), scale_cpu))
        codes += q.numel()
    n_leaves = len(leaves(grads))
    out = dict(steps=FAULT_COMPRESS_STEPS, losses=losses,
               ms_per_step=1e3 * wall / FAULT_COMPRESS_STEPS,
               k3_launches=launches, wire_bytes=stats["wire_bytes"],
               raw_bytes=stats["raw_bytes"],
               wire_over_raw=stats["wire_bytes"] / stats["raw_bytes"],
               codes=codes, leaves=n_leaves,
               leaves_with_equal_codes=leaves_equal)
    print("[fault] compression " + json.dumps(out, sort_keys=True),
          flush=True)
    if not all(np.isfinite(losses)) or launches != FAULT_COMPRESS_STEPS:
        raise AssertionError(f"[fault] compression: losses {losses}, "
                             f"{launches} K3 launches")
    if leaves_equal != n_leaves:
        raise AssertionError(f"[fault] compression: int8 codes differ "
                             f"between card and CPU on "
                             f"{n_leaves - leaves_equal} of {n_leaves} leaves")
    return out


class _Deterministic:
    """cuDNN's deterministic algorithms, and PyTorch's deterministic mode
    (warning, not raising, on an operation without a deterministic
    implementation), while the block runs; the previous settings after."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        t = self.torch
        self.saved = (t.backends.cudnn.deterministic,
                      t.backends.cudnn.benchmark,
                      t.are_deterministic_algorithms_enabled(),
                      t.is_deterministic_algorithms_warn_only_enabled())
        t.backends.cudnn.deterministic, t.backends.cudnn.benchmark = True, False
        t.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        t = self.torch
        cudnn_det, bench, det, warn = self.saved
        t.backends.cudnn.deterministic, t.backends.cudnn.benchmark = (
            cudnn_det, bench)
        t.use_deterministic_algorithms(det, warn_only=warn)


def fault_phase(torch, work):
    """[fault]: `run_resilient_loop` over ResNet-20 QAT steps (K3 at every
    step) twice without faults and once with faults at FAULT_AT, under
    deterministic algorithms (`_Deterministic`: with PyTorch's defaults
    cuDNN's float64 convolution backward may sum in another order on a
    replayed step; on an H100 a faulty run ended 1.9e-9 from two
    fault-free runs that agreed); the
    report (failures == restores == 3, final step FAULT_STEPS); the faulty
    run's final state bit-equal to the fault-free run's, or, if the two
    fault-free runs differ (the card's step not deterministic), within
    their gap; a `StragglerMonitor`'s flags; then `fault_compression`."""
    from repro_torch.distributed.fault import StragglerMonitor

    t_phase = time.perf_counter()
    monitor = StragglerMonitor()
    with _Deterministic(torch):
        clean, clean_rep, clean_k3, clean_s = fault_loop(torch, work, ())
        again, _, _, _ = fault_loop(torch, work, ())
        faulty, rep, k3_launches, faulty_s = fault_loop(
            torch, work, set(FAULT_AT), monitor)
    run_gap = max_gap(torch, again, clean)
    gap = max_gap(torch, faulty, clean)
    out = dict(steps=FAULT_STEPS, checkpoint_every=FAULT_EVERY,
               faults=list(FAULT_AT), failures=rep.failures,
               restores=rep.restores, final_step=rep.final_step,
               steps_run=rep.steps_run, stragglers=rep.stragglers,
               step_s_median=statistics.median(monitor.times),
               k3_launches=k3_launches, clean_k3_launches=clean_k3,
               clean_wall_s=clean_s, faulty_wall_s=faulty_s,
               fault_free_runs_gap=run_gap, faulty_vs_fault_free_gap=gap,
               deterministic_algorithms=True,
               fault_free_runs_equal=run_gap == 0.0,
               losses_last=rep.losses[-1])
    print("[fault] loop " + json.dumps(out, sort_keys=True), flush=True)
    if (rep.failures, rep.restores, rep.final_step) != (
            len(FAULT_AT), len(FAULT_AT), FAULT_STEPS):
        raise AssertionError(f"[fault] report {rep.failures} failures, "
                             f"{rep.restores} restores, final step "
                             f"{rep.final_step}")
    if clean_k3 != FAULT_STEPS or k3_launches != rep.steps_run:
        raise AssertionError(f"[fault] K3 launches {clean_k3} / "
                             f"{k3_launches}, expected one a step")
    if gap > run_gap:
        raise AssertionError(f"[fault] the faulty run ends {gap} from the "
                             f"fault-free run (fault-free runs: {run_gap})")
    out["compression"] = fault_compression(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[fault] phase {out['phase_s']:.1f} s", flush=True)
    return out


# ------------------------------------------------------------- 2-D meshes


def mesh2d_inputs(torch, n_layers=None, lr=None, host=None):
    """olmo-1b at full width (``n_layers`` of its layers; all by default),
    computing in float32: (model, step config, seeded train state and k = 8
    comp on the card, the batch). In bfloat16 each rank's weight gradient
    is rounded to bfloat16 before the ranks' sum, where the unmeshed step
    rounds the whole batch's sum once, which is past the train-parity
    bound; in float32 the two differ by the order of float32 sums.
    ``host``: a dict that keeps the seeded parameters drawn on the host
    for the caller's next call (the draw takes seconds at full width)."""
    import dataclasses

    from repro_torch._device import tree_to
    from repro_torch.configs import get_config
    from repro_torch.core import lm_compress
    from repro_torch.launch.train import StepConfig, make_optimizer
    from repro_torch.models.lm import build_lm
    from repro_torch.nn.spec import init_params

    cfg = dataclasses.replace(get_config(LM_ARCH), compute_dtype="float32")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_lm(cfg)
    step_cfg = StepConfig(qat=True, with_comp=True, remat=True,
                          q_block=MESH2D_BLOCK, kv_block=MESH2D_BLOCK,
                          lr=MESH2D_LR if lr is None else lr)
    host = {} if host is None else host
    if not host:
        host.update(init_params(0, model.spec, "cpu"))
    params = tree_to(host, "cuda")
    comp = lm_compress.restrict_all_codebooks(
        model, lm_compress.init_lm_comp(model, device="cuda"),
        lm_compress.symmetric_codebook_values(8))
    toks = np.random.default_rng(LM_PROMPT_SEED).integers(
        0, cfg.vocab, (MESH2D_BATCH, MESH2D_TOKENS + 1)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device="cuda"),
             "labels": torch.as_tensor(toks[:, 1:], device="cuda")}
    state = {"params": params,
             "opt": make_optimizer(step_cfg).init(params)}
    return model, step_cfg, state, comp, batch


def mesh2d_steps(torch, step, state, batch, comp, on_first=None):
    """MESH2D_STEPS steps: (final state, losses, K3 launches a step (counts
    set to 0 before each step, read after it), ms a step, the peak bytes of
    gathered tensors a meshed step reports (None unmeshed))."""
    from repro_torch.kernels.fake_quant import fake_quant as k3

    losses, launches, ms, peaks = [], [], [], []
    for i in range(MESH2D_STEPS):
        torch.cuda.synchronize()
        k3.launches = 0
        t0 = time.perf_counter()
        state, met = step(state, batch, comp)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(k3.launches)
        peak = met.pop("gathered_peak_bytes", None)
        peaks.append(None if peak is None else int(peak))
        losses.append({k: float(v) for k, v in met.items()})
        if i == 0 and on_first is not None:
            on_first(state)
    return state, losses, launches, ms, peaks


def mesh2d_one(torch, work):
    """(a): one process over NCCL, a 1 x 1 ("data", "model") process mesh
    on cuda:0, olmo-1b at full width and depth."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import Shape
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T

    init = work / "mesh2d-a.rendezvous"
    init.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"file://{init}", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=MESH2D_TIMEOUT_S))
    try:
        t0 = time.perf_counter()
        mesh = S.process_mesh((1, 1), ("data", "model"), device_type="cuda")
        model, cfg, state0, comp, batch = mesh2d_inputs(torch)
        init_s = time.perf_counter() - t0
        want, want_losses, want_k3, want_ms, _ = mesh2d_steps(
            torch, T.make_train_step(model, cfg), state0, batch, comp)
        want = {n: t.cpu() for n, t in leaves(want).items()}
        sh = T.train_state_shardings(model, mesh, S.DEFAULT_RULES)
        local = S.shard_tree(state0, sh)
        local_comp = S.shard_tree(comp, T.comp_shardings(model, mesh))
        del state0
        got, losses, k3_launches, ms, peaks = mesh2d_steps(
            torch, T.make_train_step(model, cfg, mesh=mesh,
                                     rules=S.DEFAULT_RULES),
            local, batch, local_comp)
        fw, fg = want, leaves(S.gather_tree(got, sh))
        equal = sum(torch.equal(fw[n], fg[n].cpu()) for n in fw)
        params = got["params"]
        del want, got, local
        torch.cuda.empty_cache()

        rows, plen = MESH2D_PREFILL
        toks = batch["tokens"][:rows, :plen]
        p_sh = S.make_param_shardings(model.spec, mesh)
        local_params = S.shard_tree(params, p_sh)
        logits = T.make_prefill_step(model, cfg)(params, {"tokens": toks})
        m_logits = T.make_prefill_step(model, cfg, mesh=mesh)(
            local_params, {"tokens": toks})
        with torch.no_grad():
            _, cache = model.prefill(params, toks, plen + 1)
        c_sh = T.cache_shardings(model, Shape("mesh2d", "decode", plen + 1,
                                              rows), mesh)
        nxt = batch["tokens"][:rows, plen - 1:plen]
        s_logits, s_cache = T.make_serve_step(model, cfg)(params, cache, nxt)
        m_s_logits, m_s_cache = T.make_serve_step(
            model, cfg, mesh=mesh, cache_shardings=c_sh)(
            local_params, S.shard_tree(cache, c_sh), nxt)
        cache_equal = all(torch.equal(a, b) for a, b in zip(
            leaves(s_cache).values(),
            leaves(S.gather_tree(m_s_cache, c_sh)).values()))
        out = dict(
            arch=LM_ARCH, layers=model.cfg.n_layers, mesh=mesh.shape,
            backend=dist.get_backend(), tokens=[MESH2D_BATCH, MESH2D_TOKENS],
            losses=losses, unmeshed_losses=want_losses,
            losses_equal=losses == want_losses,
            state_leaves_equal=equal, state_leaves=len(fw),
            k3_launches_per_step=k3_launches,
            unmeshed_k3_launches_per_step=want_k3,
            gathered_peak_bytes=peaks,
            ms_per_step=ms, unmeshed_ms_per_step=want_ms,
            prefill_logits_equal=bool(torch.equal(logits, m_logits)),
            serve_logits_equal=bool(torch.equal(s_logits, m_s_logits)),
            serve_cache_equal=cache_equal, init_s=init_s)
    finally:
        dist.destroy_process_group()
        init.unlink(missing_ok=True)
    print("[mesh2d] (a) " + json.dumps(out, sort_keys=True), flush=True)
    if not (out["losses_equal"] and equal == len(fw)
            and out["prefill_logits_equal"] and out["serve_logits_equal"]
            and cache_equal):
        raise AssertionError(
            f"[mesh2d] (a) the 1 x 1 mesh's steps differ from the unmeshed "
            f"ones: losses equal {out['losses_equal']}, {equal} of "
            f"{len(fw)} state leaves equal, prefill "
            f"{out['prefill_logits_equal']}, serve "
            f"{out['serve_logits_equal']} / cache {cache_equal}")
    if k3_launches != [1] * MESH2D_STEPS:
        raise AssertionError(f"[mesh2d] (a) K3 launches a step {k3_launches}")
    return out


def mesh2d_nccl_probe(rank, world):
    """One all-reduce over NCCL with ``world`` ranks on cuda:0."""
    import torch
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return float(x[0])


def first_counted(torch, step, count=True):
    """(``step`` with its first call counted when ``count``, the calls'
    records: the first's {"flops": matmul FLOPs (`FlopCounterMode`),
    "collectives": `collective_counts`}, None for the others)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import sharding as S

    calls = []

    def run(*a):
        if count and not calls:
            S.reset_collective_counts()
            with FlopCounterMode(display=False) as flops:
                res = step(*a)
            torch.cuda.synchronize()
            calls.append(dict(flops=flops.get_total_flops(),
                              collectives=S.collective_counts()))
            return res
        calls.append(None)
        return step(*a)

    return run, calls


def mesh2d_rank(rank, world, layers, lrs):
    """(b): one rank of the 2 x 2 mesh on cuda:0. At each learning rate
    every rank first runs the unmeshed steps at the same depth (rank 0
    keeps them as the reference; on the others they warm the process up),
    then the meshed steps on its slices, attention, the FFN and the
    vocabulary split over "model" (tensor-parallel); rank 0 compares. At
    the first learning rate the first step of each is counted: its matmul
    FLOPs (`FlopCounterMode`), and the meshed step's collectives by kind;
    then a meshed prefill gives the width of a rank's logits."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T

    torch.cuda.set_device(0)
    torch.set_float32_matmul_precision("highest")
    out = dict(rank=rank, backend=dist.get_backend(), runs={})
    mesh = S.process_mesh(MESH2D_SHAPE, ("data", "model"),
                          device_type="cuda")
    out["coords"] = mesh.coords
    host = {}
    for lr in lrs:
        count = lr == lrs[0]
        model, cfg, state0, comp, batch = mesh2d_inputs(torch, layers, lr,
                                                        host)
        ref = None
        if rank == 0 or count:   # rank 0's reference; the others warm up
            firsts = {}
            ref_step, ref_calls = first_counted(
                torch, T.make_train_step(model, cfg), count)
            with _ActQuant() as rec:
                ref_state, ref_losses, _, ref_ms, _ = mesh2d_steps(
                    torch, ref_step, state0, batch, comp,
                    lambda st: firsts.update(mu=leaves(st["opt"]["mu"])))
            ref = dict(state=leaves(ref_state), losses=ref_losses,
                       ms=ref_ms, mu=firsts["mu"],
                       codes=[c.numpy() for c in rec.codes])
            del ref_state
        if rank != 0:
            ref = None
        dist.barrier()
        sh = T.train_state_shardings(model, mesh)
        local = S.shard_tree(state0, sh)
        local_comp = S.shard_tree(comp, T.comp_shardings(model, mesh))
        del state0, comp
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        firsts = {}
        step, calls = first_counted(
            torch, T.make_train_step(model, cfg, mesh=mesh), count)
        with _ActQuant() as rec:
            got, losses, k3_launches, ms, peaks = mesh2d_steps(
                torch, step, local, batch, local_comp,
                lambda st: firsts.update(mu=leaves(S.gather_tree(
                    st["opt"]["mu"], sh["opt"]["mu"]))))
        peak = torch.cuda.max_memory_allocated()
        full = leaves(S.gather_tree(got, sh))
        run = dict(lr=lr, losses=losses, k3_launches_per_step=k3_launches,
                   ms_per_step=ms, peak_gb=peak / 1e9,
                   gathered_peak_bytes=peaks,
                   codes=[c.numpy() for c in rec.codes])
        if count:
            run.update(flops=calls[0]["flops"],
                       unmeshed_flops=ref_calls[0]["flops"],
                       collectives=calls[0]["collectives"])
            rows, plen = MESH2D_PREFILL
            block = T.make_prefill_step(model, cfg, mesh=mesh)(
                got["params"], {"tokens": batch["tokens"][:rows, :plen]})
            run["prefill_logits_block"] = list(block.shape)
            del block
        if rank == 0:
            run.update(
                ref_losses=ref["losses"], ref_ms_per_step=ref["ms"],
                loss_rel=max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                             for g, w in zip(losses, ref["losses"])
                             for k in w),
                grad_rel_l2_max=max(
                    float(torch.linalg.norm((firsts["mu"][n]
                                             - ref["mu"][n]).double())
                          / max(float(torch.linalg.norm(
                              ref["mu"][n].double())), 1e-30))
                    for n in ref["mu"]),
                param_max_abs=max(
                    float((full[n] - ref["state"][n]).abs().max())
                    for n in ref["state"] if n.startswith("params/")),
                ref_codes=ref["codes"])
        out["runs"][lr] = run
        del got, full, ref, local, local_comp
        torch.cuda.empty_cache()
    return out


def put_together(parts, want_shape):
    """One fake-quant call's codes from the ranks ({(data, model): codes})
    as the unmeshed call's: the data ranks' rows concatenated; a call on
    features split over "model" (the attention output before wo, the FFN
    hidden) has its model ranks' chunks concatenated along that axis; one
    computed whole is the same on both (the first is taken)."""
    rows = []
    for d in sorted({d for d, _ in parts}):
        chunks = [parts[(d, m)] for m in sorted(m for e, m in parts
                                                if e == d)]
        a = chunks[0]
        if a.shape[1:] == tuple(want_shape[1:]):
            rows.append(a)
        else:
            ax = next(i for i in range(1, a.ndim)
                      if a.shape[i] != want_shape[i])
            rows.append(np.concatenate(chunks, axis=ax))
    return np.concatenate(rows)


def mesh2d_codes(ranks, lr):
    """The int8 activation codes of (b)'s meshed run at ``lr``, the ranks'
    rows and feature chunks put together, against rank 0's unmeshed codes:
    (flips a step, codes, calls, shapes equal, calls split over
    "model")."""
    by_pos = {(r["coords"]["data"], r["coords"]["model"]):
              r["runs"][lr].pop("codes") for r in ranks}
    ref = ranks[0]["runs"][lr].pop("ref_codes")
    got = [put_together({k: v[i] for k, v in by_pos.items()}, ref[i].shape)
           for i in range(len(ref))]
    split = sum(by_pos[(0, 0)][i].shape[1:] != ref[i].shape[1:]
                for i in range(len(ref)))
    n = len(ref) // MESH2D_STEPS
    flips = [int(sum((got[i] != ref[i]).sum()
                     for i in range(s * n, (s + 1) * n) if
                     got[i].shape == ref[i].shape))
             for s in range(MESH2D_STEPS)]
    return (flips, int(sum(c.size for c in ref)), len(ref),
            all(g.shape == r.shape for g, r in zip(got, ref)), split)


def mesh2d_dry(torch):
    """The dry run of (b)'s cell (LM_ARCH in float32 at MESH2D_LAYERS, the
    2 x 2 mesh, its batch): (``gathered_peak_bytes``, the bytes of all its
    parameters, which a step that gathered the whole model would hold,
    {"flops", "collectives" of a rank's step, "padded_vocab"})."""
    import dataclasses

    from repro_torch._device import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch.dryrun import gathered_peak_bytes, step_costs
    from repro_torch.launch.train import StepConfig
    from repro_torch.models.lm import build_lm
    from repro_torch.nn.spec import abstract_params

    cfg = dataclasses.replace(get_config(LM_ARCH), compute_dtype="float32",
                              n_layers=MESH2D_LAYERS)
    model = build_lm(cfg)
    mesh = AbstractMesh(MESH2D_SHAPE, ("data", "model"))
    whole = sum(t.numel() * t.element_size()
                for t in tree_leaves(abstract_params(model.spec)))
    costs = step_costs(model, mesh, None, "train", MESH2D_BATCH,
                       MESH2D_TOKENS, StepConfig(
                           qat=True, with_comp=True, remat=True,
                           q_block=MESH2D_BLOCK, kv_block=MESH2D_BLOCK))
    return (gathered_peak_bytes(model, "train", mesh), whole,
            dict(costs, padded_vocab=cfg.padded_vocab))


def mesh2d_dry_cells():
    """The dry run's new fields of MESH2D_DRY_CELLS' ``train_4k`` on the
    32 x 8 mesh."""
    from repro_torch.launch.dryrun import run_cell

    out = []
    for arch in MESH2D_DRY_CELLS:
        cell = run_cell(arch, "train_4k", False)
        out.append({k: cell[k] for k in (
            "arch", "shape", "mesh", "gathered_peak_bytes",
            "per_device_peak_bytes", "flops", "collectives", "layout_s")})
    return out


def mesh2d_phase(torch, work):
    """[mesh2d]: (a) the 1 x 1 mesh in this process over NCCL, while four
    ranks probe NCCL on one card; (b) the 2 x 2 mesh of four processes,
    over gloo unless the probe all-reduced."""
    from repro_torch.distributed.spawn import run_ranks

    t0 = time.perf_counter()
    # NCCL refuses two ranks on one card in the versions known; the probe
    # says what this one does (its ranks run beside (a))
    with ThreadPoolExecutor(1) as pool:
        probe = pool.submit(run_ranks, mesh2d_nccl_probe, 4, backend="nccl",
                            timeout_s=MESH2D_NCCL_DEADLINE_S / 2,
                            deadline_s=MESH2D_NCCL_DEADLINE_S,
                            workdir=str(work))
        one = mesh2d_one(torch, work)
        try:
            got = probe.result()
            backend = "nccl" if got == [10.0] * 4 else "gloo"
            nccl = f"four ranks on cuda:0 all-reduce to {got}"
        except RuntimeError as e:
            backend = "gloo"
            nccl = "refused: " + " | ".join(
                line.strip() for line in str(e).strip().splitlines()[-3:]
            )[:400]
    print(f"[mesh2d] nccl {nccl}", flush=True)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    lrs = (MESH2D_LR, MESH2D_LR_TARGET)
    ranks = run_ranks(mesh2d_rank, 4, args=(MESH2D_LAYERS, lrs),
                      backend=backend, timeout_s=MESH2D_TIMEOUT_S,
                      deadline_s=MESH2D_DEADLINE_S, threads=None,
                      workdir=str(work))
    b_s = time.perf_counter() - t1
    bound_bytes, whole_bytes, want = mesh2d_dry(torch)
    runs = {}
    for lr in lrs:
        r0 = ranks[0]["runs"][lr]
        flips, n_codes, calls, shapes_equal, split = mesh2d_codes(ranks, lr)
        runs[lr] = dict(
            losses=r0["losses"], ref_losses=r0["ref_losses"],
            loss_rel=r0["loss_rel"], grad_rel_l2_max=r0["grad_rel_l2_max"],
            param_max_abs=r0["param_max_abs"], act_code_calls=calls,
            act_code_calls_split=split,
            act_codes=n_codes, act_code_flips_by_step=flips,
            act_code_shapes_equal=shapes_equal,
            ref_ms_per_step=r0["ref_ms_per_step"],
            ranks=[{k: r["runs"][lr][k] for k in (
                "k3_launches_per_step", "ms_per_step", "peak_gb",
                "gathered_peak_bytes", "flops", "unmeshed_flops",
                "collectives", "prefill_logits_block")
                if k in r["runs"][lr]}
                   | {"rank": r["rank"], "coords": r["coords"]}
                   for r in ranks])
    two = dict(arch=LM_ARCH, layers=MESH2D_LAYERS, mesh=dict(zip(
        ("data", "model"), MESH2D_SHAPE)),
        gathered_bound_bytes=bound_bytes, param_bytes=whole_bytes,
        storage_only_gathered_bytes=MESH2D_STORAGE_ONLY_GATHERED,
        dry_run=want,
        transport=backend if backend
        == "nccl" else "gloo (CUDA tensors through the host)", nccl=nccl,
        tokens=[MESH2D_BATCH, MESH2D_TOKENS], gated_lr=MESH2D_LR,
        runs=runs, backends=[r["backend"] for r in ranks], phase_b_s=b_s)
    print("[mesh2d] (b) " + json.dumps(two, sort_keys=True), flush=True)
    for cell in mesh2d_dry_cells():
        print("[mesh2d] dry " + json.dumps(cell, sort_keys=True),
              flush=True)
    gated = runs[MESH2D_LR]
    if not (gated["loss_rel"] <= LOSS_RTOL
            and gated["grad_rel_l2_max"] <= GRAD_RTOL
            and gated["param_max_abs"] <= PARAM_ATOL):
        raise AssertionError(
            f"[mesh2d] (b) 2 x 2 against unmeshed at lr {MESH2D_LR}: loss "
            f"rel {gated['loss_rel']:.3e}, gradient rel-L2 "
            f"{gated['grad_rel_l2_max']:.3e}, params abs "
            f"{gated['param_max_abs']:.3e}")
    for r in gated["ranks"]:
        if r["flops"] * 4 != r["unmeshed_flops"] \
                or r["prefill_logits_block"][-1] * 2 != want["padded_vocab"]:
            raise AssertionError(
                f"[mesh2d] (b) rank {r['rank']}: {r['flops']} matmul FLOPs "
                f"against the unmeshed step's {r['unmeshed_flops']} (1/4 "
                f"expected), logits block {r['prefill_logits_block']}")
    for lr, run in runs.items():
        if not run["act_code_shapes_equal"] \
                or run["act_code_flips_by_step"][0]:
            raise AssertionError(
                f"[mesh2d] (b) lr {lr}: the first step's activation codes "
                f"differ ({run['act_code_flips_by_step'][0]} flips, shapes "
                f"equal {run['act_code_shapes_equal']})")
        if any(r["k3_launches_per_step"] != [1] * MESH2D_STEPS
               for r in run["ranks"]):
            raise AssertionError("[mesh2d] (b) K3 launches a step: "
                                 + str([r["k3_launches_per_step"]
                                        for r in run["ranks"]]))
        # the peak stays within the dry run's bound (the embedding's and
        # one block's chunks), below the model's parameters and below what
        # the storage-only layout gathered (the whole tied embedding)
        if any(not 0 < max(r["gathered_peak_bytes"])
               <= min(bound_bytes, whole_bytes - 1,
                      MESH2D_STORAGE_ONLY_GATHERED - 1)
               for r in run["ranks"]):
            raise AssertionError(
                f"[mesh2d] (b) lr {lr}: gathered bytes a step past the dry "
                f"run's bound {bound_bytes}, not below the model's "
                f"parameters, {whole_bytes}, or not below the storage-only "
                f"layout's {MESH2D_STORAGE_ONLY_GATHERED}: "
                + str([r["gathered_peak_bytes"] for r in run["ranks"]]))
    out = dict(one=one, two=two, phase_s=time.perf_counter() - t0)
    print(f"[mesh2d] {out['phase_s']:.1f} s", flush=True)
    return out


# ------------------------------------------- (c): expert-parallel MoE


def mesh2d_moe_inputs(torch):
    """(c)'s cell: phi3.5-moe at full width and MESH2D_MOE_LAYERS layers,
    computing in float32 (as (b), for the ranks' float32 sums): (model,
    step config, the seeded parameters on the card (`shared_on_card`) and
    k = 8 comp on the host, the batch on the card)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import lm_compress
    from repro_torch.launch.train import StepConfig
    from repro_torch.models.lm import build_lm
    from repro_torch.nn.spec import init_params

    cfg = dataclasses.replace(get_config(MESH2D_MOE_ARCH),
                              compute_dtype="float32",
                              n_layers=MESH2D_MOE_LAYERS)
    model = build_lm(cfg)
    step_cfg = StepConfig(qat=True, with_comp=True, remat=True,
                          q_block=MESH2D_BLOCK, kv_block=MESH2D_BLOCK,
                          lr=MESH2D_LR)
    params = shared_on_card(torch, model.spec,
                            lambda: init_params(0, model.spec, "cpu"))
    comp = lm_compress.restrict_all_codebooks(
        model, lm_compress.init_lm_comp(model, device="cpu"),
        lm_compress.symmetric_codebook_values(8))
    toks = np.random.default_rng(LM_PROMPT_SEED).integers(
        0, cfg.vocab, (MESH2D_BATCH, MESH2D_TOKENS + 1)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device="cuda"),
             "labels": torch.as_tensor(toks[:, 1:], device="cuda")}
    return model, step_cfg, params, comp, batch


def full_on_rank0(torch, x, sharding):
    """The full tensor of the slice ``x`` on ``sharding`` on rank 0 (on the
    card), None on the others. Every rank of the mesh shares cuda:0, so
    rank 0 reads the others' slices in place through CUDA IPC (the handles
    gathered to it over the process group, a barrier holding the slices
    alive until it has copied them): the slices do not go through the
    host."""
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor

    from repro_torch.distributed.sharding import _mesh_size

    mesh = sharding.mesh
    part = x.detach().contiguous()
    root = dist.get_rank() == mesh.ranks[0]
    handles = [None] * len(mesh.ranks) if root else None
    dist.gather_object(None if root else reduce_tensor(part), handles,
                       dst=mesh.ranks[0])
    full = None
    if root:
        full = torch.empty([n * _mesh_size(mesh, e) for n, e in zip(
            part.shape, sharding.entries(part.ndim))], dtype=part.dtype,
            device=part.device)
        for r, handle in zip(mesh.ranks, handles):
            src = part if handle is None else handle[0](*handle[1])
            full[sharding.index(full.shape, mesh.coords_of(r))] = src
            del src
        torch.cuda.synchronize()
    dist.barrier()
    return full


def shared_on_card(torch, spec, draw):
    """``draw()``'s tree (seeded parameters on the host) on the card, drawn
    once, by the mesh's first rank: the other ranks, sharing cuda:0, map
    its tensors in place through CUDA IPC (the handles broadcast over the
    process group), so the processes neither draw the tree nor hold it
    once each. ``spec``: its ParamSpec tree (the leaves' order). Rank 0
    keeps the tensors alive until the callers' last barrier."""
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor

    from repro_torch._device import tree_leaves, tree_to, tree_unflatten
    from repro_torch.nn.spec import abstract_params

    box = [None]
    tree = None
    if dist.get_rank() == 0:
        tree = tree_to(draw(), "cuda")
        torch.cuda.synchronize()
        box[0] = [reduce_tensor(t) for t in tree_leaves(tree)]
    dist.broadcast_object_list(box, src=0)
    if tree is None:
        tree = tree_unflatten(abstract_params(spec), iter(
            fn(*args) for fn, args in box[0]))
    return tree


def sliced_gap(torch, tree, shardings, ref, kind):
    """The largest gap, leaf by leaf, of the full tensors whose slices
    ``tree`` holds against ``ref`` ({name: host tensor}, rank 0's),
    computed on the card in the leaves' dtype: ``"rel_l2"`` or
    ``"max_abs"``; None on the ranks but 0."""
    gaps = []
    shards = leaves(shardings)
    for name, x in leaves(tree).items():
        full = full_on_rank0(torch, x, shards[name])
        if full is None:
            continue
        want = ref[name].to(full.device)
        diff = full - want
        gaps.append(float(diff.abs().max()) if kind == "max_abs" else
                    float(torch.linalg.vector_norm(diff))
                    / max(float(torch.linalg.vector_norm(want)), 1e-30))
        del full, diff, want
    return max(gaps) if gaps else None


def mesh2d_warm_up(torch):
    """One unmeshed QAT step of (c)'s architecture at its reduced size on
    the card, its first call counted: this process's first launches (the
    kernels' modules, cuBLAS's handles, the FLOP counter's set-up), before
    rank 0's reference and the meshed steps, so that neither times
    them."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import lm_compress
    from repro_torch.launch import train as T
    from repro_torch.models.lm import build_lm
    from repro_torch.nn.spec import init_params

    model = build_lm(dataclasses.replace(
        get_config(MESH2D_MOE_ARCH).scaled_down(), n_layers=1))
    cfg = T.StepConfig(q_block=MESH2D_BLOCK, kv_block=MESH2D_BLOCK)
    params = init_params(0, model.spec, "cuda")
    comp = lm_compress.restrict_all_codebooks(
        model, lm_compress.init_lm_comp(model, device="cuda"),
        lm_compress.symmetric_codebook_values(8))
    toks = torch.zeros((2, 17), dtype=torch.int32, device="cuda")
    step, _ = first_counted(torch, T.make_train_step(model, cfg))
    step({"params": params, "opt": T.make_optimizer(cfg).init(params)},
         {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, comp)
    torch.cuda.synchronize()


def mesh2d_moe_rank(rank, world):
    """(c), then (d): one rank of the 1 x 4 mesh on cuda:0, after one
    warm-up step (`mesh2d_warm_up`): phi3.5-moe's case
    (`mesh2d_meshed_case`), then each of MESH2D_SPLIT's archs', then its
    meshed prefill and serve step (`mesh2d_split_serve`)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as S

    t0 = time.perf_counter()
    wall = [time.time()]
    torch.cuda.set_device(0)
    torch.set_float32_matmul_precision("highest")
    mesh = S.process_mesh(MESH2D_MOE_SHAPE, ("data", "model"),
                          device_type="cuda")
    mesh2d_warm_up(torch)
    out = dict(rank=rank, coords=mesh.coords, backend=dist.get_backend(),
               wall=wall)
    inputs = mesh2d_moe_inputs(torch)
    out.update(mesh2d_meshed_case(torch, mesh, rank, *inputs, t0=t0,
                                  moe_local_dispatch=True))
    del inputs
    dist.barrier()          # rank 0's shared parameters are let go
    out["split"] = {}
    for arch in MESH2D_SPLIT:
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        model, cfg, host, comp, batch = mesh2d_split_inputs(torch, arch)
        case = mesh2d_meshed_case(torch, mesh, rank, model, cfg, host, comp,
                                  batch, t0=t1)
        torch.cuda.empty_cache()
        case["serve"] = mesh2d_split_serve(torch, mesh, rank, model, cfg,
                                           host, batch)
        case["case_s"] = time.perf_counter() - t1
        out["split"][arch] = case
        del host, batch
        dist.barrier()
    wall.append(time.time())
    return out


def mesh2d_meshed_case(torch, mesh, rank, model, cfg, host, comp, batch, *,
                       t0, moe_local_dispatch=False):
    """One arch's meshed QAT steps against the unmeshed ones on this rank
    of the 1 x 4 mesh. Rank 0 first runs the unmeshed steps at the same
    depth (the others wait: the card holds one unmeshed state), keeps its
    parameters, first Adam moment and codes on the host, frees the card;
    then every rank runs the meshed steps on its slices, its split units
    over "model"; rank 0 compares."""
    import torch.distributed as dist

    from repro_torch._device import tree_to
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T

    out = dict(init_s=time.perf_counter() - t0)

    def state_of(params):
        """A train state no caller holds: each step frees the last."""
        return {"params": params, "opt": T.make_optimizer(cfg).init(params)}

    ref = None
    if rank == 0:
        firsts = {}
        torch.cuda.reset_peak_memory_stats()
        step, calls = first_counted(torch, T.make_train_step(model, cfg))
        with _ActQuant() as rec:
            st, losses, launches, ms, _ = mesh2d_steps(
                torch, step, state_of(tree_to(host, "cuda")), batch,
                tree_to(comp, "cuda"),
                lambda st: firsts.update(mu={
                    n: t.cpu() for n, t in leaves(st["opt"]["mu"]).items()}))
        ref = dict(params={n: t.cpu() for n, t in leaves(
            st["params"]).items()}, mu=firsts["mu"], losses=losses,
            k3_launches_per_step=launches, ms_per_step=ms,
            flops=calls[0]["flops"],
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            codes=[c.numpy() for c in rec.codes[:len(rec.codes)
                                                // MESH2D_STEPS]])
        del st, rec
        torch.cuda.empty_cache()
    out["ref_s"] = time.perf_counter() - t0
    dist.barrier()
    sh = T.train_state_shardings(model, mesh)
    local_comp = S.shard_tree(comp, T.comp_shardings(model, mesh),
                              device="cuda")
    torch.cuda.reset_peak_memory_stats()
    firsts = {}
    step, calls = first_counted(torch, T.make_train_step(
        model, cfg, mesh=mesh, moe_local_dispatch=moe_local_dispatch))
    with _ActQuant() as rec:
        got, losses, launches, ms, peaks = mesh2d_steps(
            torch, step, state_of(S.shard_tree(host, sh["params"],
                                               device="cuda")),
            batch, local_comp,
            lambda st: firsts.update(grad=sliced_gap(
                torch, st["opt"]["mu"], sh["opt"]["mu"],
                ref and ref["mu"], "rel_l2")))
    out.update(losses=losses, k3_launches_per_step=launches, ms_per_step=ms,
               steps_s=time.perf_counter() - t0,
               gathered_peak_bytes=peaks, flops=calls[0]["flops"],
               collectives=calls[0]["collectives"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    out["codes"] = mesh2d_code_flips(
        mesh, [c.numpy() for c in rec.codes[:len(rec.codes)
                                            // MESH2D_STEPS]],
        ref and ref["codes"])
    del rec
    param_gap = sliced_gap(torch, got["params"], sh["params"],
                           ref and ref["params"], "max_abs")
    if rank == 0:
        out.update(
            ref={k: v for k, v in ref.items()
                 if k not in ("params", "mu", "codes")},
            loss_rel=max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                         for g, w in zip(losses, ref["losses"]) for k in w),
            grad_rel_l2_max=firsts["grad"], param_max_abs=param_gap)
    out["rank_s"] = time.perf_counter() - t0
    del got
    return out


def mesh2d_split_inputs(torch, arch):
    """(d)'s cell of ``arch``: at full width and MESH2D_SPLIT's depth,
    computing in float32 (as (b) and (c)): (model, step config, the seeded
    parameters on the card (`shared_on_card`) and k = 8 comp on the host,
    the batch on the card, with whisper's MESH2D_ENC_FRAMES seeded stub
    frames)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import lm_compress
    from repro_torch.launch.train import StepConfig
    from repro_torch.models.lm import build_lm
    from repro_torch.nn.spec import init_params

    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32",
                              **MESH2D_SPLIT[arch])
    model = build_lm(cfg)
    step_cfg = StepConfig(qat=True, with_comp=True, remat=True,
                          q_block=MESH2D_BLOCK, kv_block=MESH2D_BLOCK,
                          lr=MESH2D_LR)
    params = shared_on_card(torch, model.spec,
                            lambda: init_params(0, model.spec, "cpu"))
    comp = lm_compress.restrict_all_codebooks(
        model, lm_compress.init_lm_comp(model, device="cpu"),
        lm_compress.symmetric_codebook_values(8))
    rng = np.random.default_rng(LM_PROMPT_SEED)
    toks = rng.integers(0, cfg.vocab, (MESH2D_BATCH, MESH2D_TOKENS + 1)
                        ).astype(np.int32)
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device="cuda"),
             "labels": torch.as_tensor(toks[:, 1:], device="cuda")}
    if cfg.encoder_decoder:
        batch["enc_embeds"] = torch.as_tensor(rng.standard_normal(
            (MESH2D_BATCH, MESH2D_ENC_FRAMES, cfg.d_model)).astype(
                np.float32), device="cuda")
    return model, step_cfg, params, comp, batch


def mesh2d_split_serve(torch, mesh, rank, model, cfg, host, batch):
    """(d)'s meshed prefill and one serve step, as a user runs them (float32,
    no QAT), on MESH2D_PREFILL's rows x prompt tokens (whisper: their
    frames too), from the unmeshed prefill's cache (each rank computes it)
    held on `cache_shardings` (K/V heads and recurrent channels over
    "model"): the logits put together on rank 0 against the unmeshed
    forward's and decode step's (max abs, and the unmeshed logits' max
    abs over the real vocabulary, the gate's scale; None on the other
    ranks), the serve step's collectives and each step's ms. Rank 0 also
    reports the unmeshed
    forward and decode step with TF32 products against the float32 ones
    (``tf32_*``): what a kernel that drops the products to a 10-bit
    mantissa moves the logits by, against which the gate's bound is set."""
    from repro_torch.configs import Shape
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T

    rows, plen = MESH2D_PREFILL
    vocab, real = model.cfg.padded_vocab, model.cfg.vocab
    enc = batch.get("enc_embeds")
    prompt = {"tokens": batch["tokens"][:rows, :plen]}
    if enc is not None:
        prompt["enc_embeds"] = enc[:rows]
    token = batch["labels"][:rows, plen - 1:plen]
    blocks = dict(q_block=cfg.q_block, kv_block=cfg.kv_block)
    local = S.shard_tree(host, S.make_param_shardings(model.spec, mesh))
    c_sh = T.cache_shardings(model, Shape(
        "d", "decode", MESH2D_ENC_FRAMES if enc is not None else plen + 1,
        rows), mesh, dtype=torch.float32)

    def unmeshed():     # (forward, cache, decode step); rank 0's logits
        want = model.forward(host, prompt["tokens"],
                             enc_embeds=prompt.get("enc_embeds"),
                             **blocks)[0] if rank == 0 else None
        _, cache = model.prefill(host, prompt["tokens"], plen + 1,
                                 enc_embeds=prompt.get("enc_embeds"),
                                 cache_dtype=torch.float32, **blocks)
        return want, cache, model.decode_step(host, cache, token)[0] \
            if rank == 0 else None

    out = {}
    with torch.no_grad():
        want, cache, want_dec = unmeshed()
        if rank == 0:
            torch.set_float32_matmul_precision("high")
            try:
                tf32, _, tf32_dec = unmeshed()
            finally:
                torch.set_float32_matmul_precision("highest")
            out.update(tf32_prefill_max_abs=float((tf32 - want).abs().max()),
                       tf32_serve_max_abs=float(
                           (tf32_dec - want_dec).abs().max()))
            del tf32, tf32_dec
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block = T.make_prefill_step(model, cfg, mesh=mesh)(local, prompt)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["prefill_block"] = list(block.shape)
    full = full_on_rank0(torch, block, S.logits_sharding(
        mesh, (rows, plen, vocab)))
    held = S.shard_tree(cache, c_sh)
    del cache
    S.reset_collective_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, _ = T.make_serve_step(model, cfg, mesh=mesh,
                              cache_shardings=c_sh)(local, held, token)
    torch.cuda.synchronize()
    out["serve_ms"] = (time.perf_counter() - t0) * 1e3
    out["serve_collectives"] = S.collective_counts()
    full_dec = full_on_rank0(torch, lg, S.logits_sharding(
        mesh, (rows, 1, vocab)))
    if rank == 0:
        out.update(
            prefill_max_abs=float((full - want).abs().max()),
            serve_max_abs=float((full_dec - want_dec).abs().max()),
            prefill_logit_max_abs=float(want[..., :real].abs().max()),
            serve_logit_max_abs=float(want_dec[..., :real].abs().max()))
    return out


def mesh2d_logit_bound(scale):
    """The bound on a meshed step's logits against the unmeshed ones whose
    max abs is ``scale``: `tests/test_torch_mesh2d.py`'s MESH2D_LOGIT_ATOL
    where the logits stay within 1, and that share of ``scale`` past it
    (float32 sums in another order move a logit by ulps of its size)."""
    return MESH2D_LOGIT_ATOL * max(1.0, scale)


def mesh2d_moe_dry(torch):
    """The dry run of (c)'s cell on its 1 x 4 mesh and on one position:
    (``gathered_peak_bytes``, {"flops", "collectives"} a rank, the 1 x 1
    step's {"flops", ...})."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch.dryrun import gathered_peak_bytes, step_costs
    from repro_torch.launch.train import StepConfig
    from repro_torch.models.lm import build_lm

    cfg = dataclasses.replace(get_config(MESH2D_MOE_ARCH),
                              compute_dtype="float32",
                              n_layers=MESH2D_MOE_LAYERS)
    model = build_lm(cfg)
    step_cfg = StepConfig(qat=True, with_comp=True, remat=True,
                          q_block=MESH2D_BLOCK, kv_block=MESH2D_BLOCK)
    mesh = AbstractMesh(MESH2D_MOE_SHAPE, ("data", "model"))
    one = AbstractMesh((1, 1), ("data", "model"))
    return (gathered_peak_bytes(model, "train", mesh),
            step_costs(model, mesh, None, "train", MESH2D_BATCH,
                       MESH2D_TOKENS, step_cfg),
            step_costs(model, one, None, "train", MESH2D_BATCH,
                       MESH2D_TOKENS, step_cfg))


def mesh2d_code_flips(mesh, codes, ref):
    """This rank's share of comparing the meshed step's first-step
    activation codes with the unmeshed step's (``ref``, rank 0's; None on
    the others), without sending the codes back from the ranks: rank 0
    names the calls split over "model" (their shape is not the unmeshed
    one), every rank sends it those calls' chunks and a digest of each
    other call, and rank 0 puts the chunks together. Returns, on rank 0,
    (flips, codes, calls, shapes equal, calls split over "model"), None on
    the others."""
    import torch.distributed as dist

    root = mesh.ranks[0]
    box = [None if ref is None else sorted(
        i for i, (c, r) in enumerate(zip(codes, ref))
        if c.shape != r.shape)]
    dist.broadcast_object_list(box, src=root)
    split = box[0]
    mine = dict(coords=mesh.coords, calls=len(codes),
                split=[codes[i] for i in split if i < len(codes)],
                digests=[hashlib.sha1(c.tobytes()).hexdigest()
                         for i, c in enumerate(codes) if i not in split])
    parts = [None] * len(mesh.ranks) if dist.get_rank() == root else None
    dist.gather_object(mine, parts, dst=root)
    if parts is None:
        return None
    flips, shapes = 0, all(p["calls"] == len(ref) for p in parts)
    own = parts[0]
    shapes &= all(p["digests"] == own["digests"] for p in parts)
    for i, r in enumerate(ref):
        if i in split:
            j = split.index(i)
            got = put_together({(p["coords"]["data"], p["coords"]["model"]):
                                p["split"][j] for p in parts}, r.shape)
        else:
            got = codes[i]
        shapes &= got.shape == r.shape
        if got.shape == r.shape:
            flips += int((got != r).sum())
    return flips, int(sum(c.size for c in ref)), len(ref), shapes, \
        len(split)


def mesh2d_moe_codes(ranks):
    """(c)'s or a (d) cell's first-step activation codes against the
    unmeshed step's, as rank 0 compared them (`mesh2d_code_flips`):
    (flips, codes, calls, shapes equal, calls split over "model")."""
    return [r.pop("codes") for r in ranks][0]


def mesh2d_moe_phase(torch, work, backend):
    """[mesh2d] (c): phi3.5-moe's expert-parallel QAT step on a 1 x 4 mesh
    of four processes on cuda:0 against the unmeshed step (module
    docstring, 22)."""
    from repro_torch.distributed.spawn import run_ranks
    from repro_torch.launch.dryrun import run_cell

    t0 = time.perf_counter()
    spawned = time.time()
    ranks = run_ranks(mesh2d_moe_rank, 4, backend=backend,
                      timeout_s=MESH2D_MOE_TIMEOUT_S,
                      deadline_s=MESH2D_MOE_DEADLINE_S, threads=None,
                      workdir=str(work))
    ranks_s = time.perf_counter() - t0
    returned = time.time()
    # the spawn's own seconds: until the first rank starts its work, and
    # from the last rank's end until run_ranks returns (results sent back)
    spawn_s = [min(r["wall"][0] for r in ranks) - spawned,
               returned - max(r["wall"][1] for r in ranks)]
    bound, want, alone = mesh2d_moe_dry(torch)
    flips, n_codes, calls, shapes_equal, split = mesh2d_moe_codes(ranks)
    r0 = ranks[0]
    by_unit, one_by_unit = want["flops"]["by_unit"], alone["flops"][
        "by_unit"]
    out = dict(
        arch=MESH2D_MOE_ARCH, layers=MESH2D_MOE_LAYERS,
        mesh=dict(zip(("data", "model"), MESH2D_MOE_SHAPE)),
        transport=backend if backend == "nccl"
        else "gloo (CUDA tensors through the host)",
        tokens=[MESH2D_BATCH, MESH2D_TOKENS], lr=MESH2D_LR,
        losses=r0["losses"], ref_losses=r0["ref"]["losses"],
        loss_rel=r0["loss_rel"], grad_rel_l2_max=r0["grad_rel_l2_max"],
        param_max_abs=r0["param_max_abs"], act_code_flips_step1=flips,
        act_codes=n_codes, act_code_calls=calls,
        act_code_calls_split=split, act_code_shapes_equal=shapes_equal,
        ref_flops=r0["ref"]["flops"], ref_ms_per_step=r0["ref"][
            "ms_per_step"], ref_peak_gb=r0["ref"]["peak_gb"],
        ref_k3_launches_per_step=r0["ref"]["k3_launches_per_step"],
        gathered_bound_bytes=bound, dry_run=want,
        dry_run_flops_1x1=alone["flops"],
        ranks=[{k: r[k] for k in (
            "rank", "coords", "backend", "k3_launches_per_step",
            "ms_per_step", "peak_gb", "gathered_peak_bytes", "flops",
            "collectives", "init_s", "ref_s", "steps_s", "rank_s")}
               for r in ranks],
        ranks_s=ranks_s, spawn_s=spawn_s)
    print("[mesh2d] (c) " + json.dumps(out, sort_keys=True), flush=True)
    cell = run_cell(MESH2D_MOE_ARCH, "train_4k", False,
                    moe_local_dispatch=True)
    print("[mesh2d] dry --moe-local " + json.dumps(
        {k: cell[k] for k in ("arch", "shape", "mesh", "moe_local_dispatch",
                              "gathered_peak_bytes",
                              "per_device_peak_bytes", "flops",
                              "collectives", "layout_s")}, sort_keys=True),
        flush=True)
    if not (out["loss_rel"] <= LOSS_RTOL
            and out["grad_rel_l2_max"] <= GRAD_RTOL
            and out["param_max_abs"] <= PARAM_ATOL):
        raise AssertionError(
            f"[mesh2d] (c) 1 x 4 against unmeshed at lr {MESH2D_LR}: loss "
            f"rel {out['loss_rel']:.3e}, gradient rel-L2 "
            f"{out['grad_rel_l2_max']:.3e}, params abs "
            f"{out['param_max_abs']:.3e}")
    if flips or not shapes_equal or not split:
        raise AssertionError(
            f"[mesh2d] (c) the first step's activation codes differ ({flips} "
            f"flips, shapes equal {shapes_equal}, {split} calls split)")
    # the experts and attention split 4 ways; the router runs whole on
    # every model rank (the rows are not split: 1 x 4)
    quarter = all(by_unit[u] * 4 == one_by_unit[u]
                  for u in ("moe", "attention")) \
        and by_unit["router"] == one_by_unit["router"]
    if not (quarter and alone["flops"]["total"] == out["ref_flops"]):
        raise AssertionError(
            f"[mesh2d] (c) the dry run's FLOPs by unit {by_unit} against "
            f"the unmeshed {one_by_unit}; counted unmeshed "
            f"{out['ref_flops']}")
    for r in out["ranks"]:
        if r["flops"] != want["flops"]["total"] \
                or r["collectives"] != want["collectives"]:
            raise AssertionError(
                f"[mesh2d] (c) rank {r['rank']}: {r['flops']} matmul FLOPs "
                f"and collectives {r['collectives']} against the dry run's "
                f"{want['flops']['total']} and {want['collectives']}")
        if r["k3_launches_per_step"] != [1] * MESH2D_STEPS:
            raise AssertionError(f"[mesh2d] (c) rank {r['rank']}: K3 "
                                 f"launches a step {r['k3_launches_per_step']}")
        if max(r["gathered_peak_bytes"]) > bound:
            raise AssertionError(
                f"[mesh2d] (c) rank {r['rank']}: gathered bytes "
                f"{r['gathered_peak_bytes']} past the dry run's {bound}")
    out["phase_s"] = time.perf_counter() - t0
    print(f"[mesh2d] (c) {out['phase_s']:.1f} s", flush=True)
    out["split"] = mesh2d_split_report(torch, ranks, backend)
    print(f"[mesh2d] (d) reported at {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def mesh2d_split_dry(torch, arch):
    """The dry run of (d)'s cell of ``arch`` (its depth, float32, the
    batch, whisper's frames apart from its tokens): ({"flops",
    "collectives"} a rank on the 1 x 4 mesh, the 1 x 1 step's, the
    gathered bytes' bound)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch.dryrun import gathered_peak_bytes, step_costs
    from repro_torch.launch.train import StepConfig
    from repro_torch.models.lm import build_lm

    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32",
                              **MESH2D_SPLIT[arch])
    model = build_lm(cfg)
    step_cfg = StepConfig(qat=True, with_comp=True, remat=True,
                          q_block=MESH2D_BLOCK, kv_block=MESH2D_BLOCK)
    kw = dict(enc_seq=MESH2D_ENC_FRAMES) if cfg.encoder_decoder else {}
    mesh = AbstractMesh(MESH2D_MOE_SHAPE, ("data", "model"))
    return (step_costs(model, mesh, None, "train", MESH2D_BATCH,
                       MESH2D_TOKENS, step_cfg, **kw),
            step_costs(model, AbstractMesh((1, 1), ("data", "model")), None,
                       "train", MESH2D_BATCH, MESH2D_TOKENS, step_cfg, **kw),
            gathered_peak_bytes(model, "train", mesh))


def mesh2d_split_report(torch, ranks, backend):
    """[mesh2d] (d): each of MESH2D_SPLIT's archs, from (c)'s ranks: a line
    a cell, then its gates (module docstring, 29)."""
    out = {}
    for arch in MESH2D_SPLIT:
        cases = [dict(r["split"][arch], rank=r["rank"], coords=r["coords"])
                 for r in ranks]
        want, alone, bound = mesh2d_split_dry(torch, arch)
        flips, n_codes, calls, shapes_equal, split = mesh2d_moe_codes(
            cases)
        r0 = cases[0]
        cell = dict(
            arch=arch, depth=MESH2D_SPLIT[arch],
            mesh=dict(zip(("data", "model"), MESH2D_MOE_SHAPE)),
            transport=backend if backend == "nccl"
            else "gloo (CUDA tensors through the host)",
            tokens=[MESH2D_BATCH, MESH2D_TOKENS], lr=MESH2D_LR,
            enc_frames=MESH2D_ENC_FRAMES
            if "n_enc_layers" in MESH2D_SPLIT[arch] else None,
            losses=r0["losses"], ref_losses=r0["ref"]["losses"],
            loss_rel=r0["loss_rel"], grad_rel_l2_max=r0["grad_rel_l2_max"],
            param_max_abs=r0["param_max_abs"], act_code_flips_step1=flips,
            act_codes=n_codes, act_code_calls=calls,
            act_code_calls_split=split, act_code_shapes_equal=shapes_equal,
            ref_flops=r0["ref"]["flops"],
            ref_ms_per_step=r0["ref"]["ms_per_step"],
            ref_peak_gb=r0["ref"]["peak_gb"],
            ref_k3_launches_per_step=r0["ref"]["k3_launches_per_step"],
            gathered_bound_bytes=bound, dry_run=want,
            dry_run_flops_1x1=alone["flops"],
            **{k: r0["serve"][k] for k in r0["serve"]
               if k.endswith("_max_abs")},
            ranks=[{k: c[k] for k in (
                "rank", "coords", "k3_launches_per_step", "ms_per_step",
                "peak_gb", "gathered_peak_bytes", "flops", "collectives",
                "init_s", "ref_s", "steps_s", "rank_s", "case_s")}
                   | {k: v for k, v in c["serve"].items()
                      if not k.endswith("_max_abs")} for c in cases])
        print(f"[mesh2d] (d) {arch} " + json.dumps(cell, sort_keys=True),
              flush=True)
        out[arch] = (cell, want, alone, bound, flips, shapes_equal, split)
    for arch, (cell, want, alone, bound, flips, shapes_equal,
               split) in out.items():
        tag = f"[mesh2d] (d) {arch}"
        if not (cell["loss_rel"] <= LOSS_RTOL
                and cell["grad_rel_l2_max"] <= GRAD_RTOL
                and cell["param_max_abs"] <= PARAM_ATOL):
            raise AssertionError(
                f"{tag} 1 x 4 against unmeshed at lr {MESH2D_LR}: loss rel "
                f"{cell['loss_rel']:.3e}, gradient rel-L2 "
                f"{cell['grad_rel_l2_max']:.3e}, params abs "
                f"{cell['param_max_abs']:.3e}")
        if flips or not shapes_equal or not split:
            raise AssertionError(
                f"{tag}: the first step's activation codes differ ({flips} "
                f"flips, shapes equal {shapes_equal}, {split} calls split)")
        if alone["flops"]["total"] != cell["ref_flops"] \
                or cell["ref_k3_launches_per_step"] != [1] * MESH2D_STEPS:
            raise AssertionError(
                f"{tag}: the unmeshed step counted {cell['ref_flops']} "
                f"matmul FLOPs against the 1 x 1 dry run's "
                f"{alone['flops']['total']}, K3 launches "
                f"{cell['ref_k3_launches_per_step']}")
        for r in cell["ranks"]:
            if r["flops"] != want["flops"]["total"] \
                    or r["collectives"] != want["collectives"]:
                raise AssertionError(
                    f"{tag} rank {r['rank']}: {r['flops']} matmul FLOPs and "
                    f"collectives {r['collectives']} against the dry run's "
                    f"{want['flops']['total']} and {want['collectives']}")
            if r["k3_launches_per_step"] != [1] * MESH2D_STEPS:
                raise AssertionError(
                    f"{tag} rank {r['rank']}: K3 launches a step "
                    f"{r['k3_launches_per_step']}")
            if max(r["gathered_peak_bytes"]) > bound:
                raise AssertionError(
                    f"{tag} rank {r['rank']}: gathered bytes "
                    f"{r['gathered_peak_bytes']} past the dry run's {bound}")
        # the float32 steps as run: the split sums' order moves a logit by
        # ulps of its size (MESH2D_LOGIT_ATOL of the logits' max abs)
        for kind in ("prefill", "serve"):
            err = cell[f"{kind}_max_abs"]
            limit = mesh2d_logit_bound(cell[f"{kind}_logit_max_abs"])
            if not err <= limit:
                raise AssertionError(
                    f"{tag}: meshed {kind} logits max abs {err:.3e} against "
                    f"the unmeshed, past {limit:.3e} (logits' max abs "
                    f"{cell[f'{kind}_logit_max_abs']:.3e})")
    return {arch: v[0] for arch, v in out.items()}


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
    from repro_torch.kernels.lut_matmul import lut_matmul as k2
    from repro_torch.kernels.lut_matmul import ops, ref
    from repro_torch.kernels.fake_quant import fake_quant as k3
    from repro_torch.kernels.transition_energy import transition_energy as k1
    from repro_torch.nn.cnn import resnet20, resnet50

    torch.set_float32_matmul_precision("highest")   # no TF32 in the library call
    t_start = time.perf_counter()

    def mark(phase):
        """Where the script's time goes: seconds since the start, each
        phase."""
        print(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    # every nvcc starts now; K2's (its 36 kernels, the longest build)
    # finishes while the phases that launch no K2 run: K1's, K3's, [cosim],
    # [train], [fault] and [mesh2d]
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(1) as pool:
        k2_build = pool.submit(build_kernels, [k2.LIBRARY])
        build_kernels([k1.LIBRARY, k3.LIBRARY])
        mark("K1 and K3 builds")
        k1_rows = k1_phase(torch, k1_cases(torch, resnet20().comp_layers))
        k3_rows = k3_phase(torch, k3_cases(torch, resnet20().comp_layers))
        k3_group_rows, k3_forward = k3_group_phase(torch,
                                                   resnet20().comp_layers)
        k3_cand_rows, k3_cand = k3_candidate_phase(torch,
                                                   resnet20().comp_layers)
        mark("K1 and K3 phases")
        cosim = cosim_phase(torch, work)
        torch.cuda.empty_cache()
        train_phase(torch)
        torch.cuda.empty_cache()
        fault = fault_phase(torch, work)
        torch.cuda.empty_cache()
        mark("[cosim], [train], [fault]")
        mesh2d = mesh2d_phase(torch, work)
        torch.cuda.empty_cache()
        mark("[mesh2d]")
        mesh2d["moe"] = mesh2d_moe_phase(
            torch, work, "nccl" if mesh2d["two"]["transport"] == "nccl"
            else "gloo")
        torch.cuda.empty_cache()
        mark("[mesh2d] (c), (d)")
        k2_build.result()
    mark("K2 build")

    k2_design = {str(cfg): k2.config(cfg) for cfg in (
        k2.K2Config(bm, bn, dq) for bm, bn in k2.TILES
        for dq in k2.DEQUANT)}
    print("[k2-design] " + json.dumps(k2_design, sort_keys=True), flush=True)
    k2_rows = k2_phase(torch, ops, ref, k2_cases(torch, resnet20(),
                                                 resnet50()))
    mark("K2")
    k2_tune = k2_tune_phase(torch, ops, ref, work)
    mark("[k2-tune]")

    k2_launches = serve_path(torch, ROOT / "build" / "chip_smoke")
    k1_launches, k1_path, mesh_prof = profile_path(torch)
    mark("[serve], [profile]")
    serial_launches, _, _ = compress_path(torch, "serial")
    torch.cuda.empty_cache()
    sweep = sweep_phase(torch, ROOT / "build" / "chip_smoke" / "sweep")
    torch.cuda.empty_cache()
    compress_launches, compress_stages, compress_fwds = compress_path(torch)
    torch.cuda.empty_cache()
    mark("[compress], [sweep]")
    lm, lm_k2_rows, lm_k3 = lm_phase(torch, ops, ref, work)
    torch.cuda.empty_cache()
    mark("[lm] .. [lm-fleet]")
    lm_train = lm_train_phase(torch, work)
    lm_train_parity = lm_train_parity_phase(torch)
    torch.cuda.empty_cache()
    mark("[lm-train], [lm-train-parity]")
    recurrent, rec_k2_rows, rec_k3, scan_params = lm_recurrent_phase(
        torch, ops, ref, work)
    rec_models = recurrent["models"]
    torch.cuda.empty_cache()
    scan = lm_scan_phase(torch, ops, ref, scan_params)
    del scan_params
    mark("[lm-recurrent], [lm-scan]")
    table1 = table1_phase(torch)
    mark("[table1]")
    encdec, encdec_k2_rows, encdec_k3 = lm_encdec_phase(torch, ops, ref)
    torch.cuda.empty_cache()
    mark("[lm-encdec]")
    moe, moe_k2_rows, moe_k3 = lm_moe_phase(torch, ops, ref)
    torch.cuda.empty_cache()
    mark("[lm-moe]")
    vlm, vlm_k2_rows, vlm_k3 = lm_vlm_phase(torch, ops, ref)
    mark("[lm-vlm]")

    padded = [r for r in k2_rows if r["per_forward"] and not r["serve_rows"]]
    unpadded = [r for r in k2_rows if r["per_forward"] and r["serve_rows"]]
    total = {key: sum(r[key] * r["per_forward"] for r in padded)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "device_ms", "library_device_ms")}
    serve_total = {f"serve_path_{key}": sum(r[key] * r["per_forward"]
                                            for r in unpadded)
                   for key in ("ms", "library_ms", "bound_ms", "device_ms",
                               "library_device_ms")}
    by_bytes = sum(r["bound_ms"] * r["per_forward"] for r in padded
                   if r["bound_by"] == "bytes")
    k2_entry = {
        **K2, "route": "cuda", "launches": k2_launches,
        "max_abs_err": max(r["max_abs_err"]
                           for r in k2_rows + lm_k2_rows + rec_k2_rows
                           + encdec_k2_rows + moe_k2_rows + vlm_k2_rows),
        **total,
        "bound_by": "bytes" if by_bytes >= total["bound_ms"] / 2
        else "operations",
        **serve_total,
        "scope": f"sum over one ResNet-20 serve forward at batch {BATCH} "
                 "(per-shape times x launches per forward): ms, plain_ms, "
                 "library_ms, bound_ms, device_ms and library_device_ms "
                 "with X padded to K_pad, serve_path_* on the serve path's "
                 "unpadded rows; ms, plain_ms, library_ms: one call between "
                 "CUDA events, the card idle before it; device_ms, "
                 "library_device_ms: one call's device time, by `timing`",
        "timing": sorted({t for r in k2_rows for t in r["timing"]}),
        "compress_path_launches": compress_launches["K2"],
        "design": k2_design,
        "configs_launched": {str(cfg): n for cfg, n in
                             sorted(k2.configs.items(), key=str)},
        "configs_scope": "launches a configuration over the whole script "
                         "(a call without one resolves through the default "
                         "tuner's model), the phases' timing launches "
                         "included, [k2-tune]'s not",
        "tune": dict(k2_tune, scope="[k2-tune]: a BlockAutotuner on the "
                     "card's balance, measuring the model's top "
                     f"{K2_TUNE_TOP} configurations (device time in a CUDA "
                     "graph) at each shape; untuned = default_config(N); "
                     "main = what a call without a configuration resolves "
                     "to (the default tuner's model); ms are device time in "
                     "a CUDA graph, library_ms torch.matmul on the "
                     "dequantized weights; decode_step: "
                     f"{LM_ARCH}'s 112 K2 calls at M = {LM_PROMPTS} between "
                     "CUDA events (*_ms) and as one CUDA graph "
                     "(*_device_ms); host_issue_*_ms: host ms to issue "
                     "them, resolving each configuration or given it"),
        "shapes": k2_rows,
        "lm": {
            "scope": f"{LM_ARCH} at full width: per-shape rows (M = "
                     f"{LM_PROMPTS * LM_PROMPT_LEN} prefill, {LM_PROMPTS} "
                     "decode; float32 and bfloat16 X; the gate's SiLU); "
                     "steps: the K2 calls one served float32 prefill and "
                     "decode step made, recorded and replayed back to back "
                     "between CUDA events through the kernel (ms), its "
                     "plain version (plain_ms) and torch.matmul on the "
                     "dequantized weights (library_ms), bound_ms summed "
                     "over those calls, launches counted in the served run",
            "launches": lm["serve_path_launches"]["K2"],
            "launches_per_prefill": lm["serve"]["float32"][
                "launches_prefill"]["served"]["K2"],
            "launches_per_decode_step": lm["serve"]["float32"][
                "launches_decode_step"]["served"]["K2"],
            "export_path_launches": {st: v["K2"] for st, v in
                                     lm["launches_per_stage"].items()},
            "steps": {step: dict(
                lm["breakdown"][step]["k2_step"],
                launches=lm["serve"]["float32"][key]["served"]["K2"])
                for step, key in (("prefill", "launches_prefill"),
                                  ("decode_step", "launches_decode_step"))},
            "shapes": lm_k2_rows,
            "engine": {
                "scope": "[lm-engine] (b): the packed-LUT serving engine "
                         f"(lut_serve=True) on {LM_ARCH} at full width, "
                         f"{LM_ENGINE_LAYERS} layers, {LM_LUT_REQUESTS} "
                         "requests; launches: its engine-mode run (counts "
                         "set to 0 before the engine was built, read after "
                         f"its trace), {7 * LM_ENGINE_LAYERS} a forward "
                         "call; by mode: each mode's run",
                "launches": lm["engine"]["lut"]["runs"]["engine"][
                    "launches"]["K2"],
                "launches_by_mode": {
                    mode: r["launches"]["K2"]
                    for mode, r in lm["engine"]["lut"]["runs"].items()},
                "forward_calls_by_mode": {
                    mode: r["forward_calls"]
                    for mode, r in lm["engine"]["lut"]["runs"].items()},
                "stage_launches": lm["engine"]["stage"]["launches"]["K2"],
            },
            "fleet": {
                "scope": "[lm-fleet]: the fleet router over base / k8 / k4 "
                         f"of {LM_ARCH} at full width, {LM_FLEET_LAYERS} "
                         "layers, with lut_serve=True engines, burst then "
                         "trickle; launches: that run (counts set to 0 "
                         "before the fleet was built, read after its "
                         f"trace), per_plan by engine, {7 * LM_FLEET_LAYERS}"
                         " a forward call of a compressed plan's engine",
                "launches": lm["fleet"]["lut"]["launches"]["K2"],
                "per_plan": {pid: c["K2"] for pid, c in
                             lm["fleet"]["lut"]["per_plan"].items()},
                "forward_calls": {pid: c["forward_calls"] for pid, c in
                                  lm["fleet"]["lut"]["per_plan"].items()},
                "fake_quant_fleet_launches": lm["fleet"]["fake_quant"][
                    "launches"]["K2"],
            },
        },
        "lm_recurrent": {
            "scope": "[lm-recurrent]: mamba2-1.3b and recurrentgemma-2b at "
                     "full width; shapes: their new (K, N) pairs at M = "
                     f"{LM_PROMPTS * LM_PROMPT_LEN} and {LM_PROMPTS}, "
                     "float32 and bfloat16 X, timed as the [lm] rows; "
                     "launches: each family's served float32 and bfloat16 "
                     "prefill and decode runs (counts set to 0 before, read "
                     "after), one a matmul: 96 a mamba2 forward, 200 a "
                     "recurrentgemma forward",
            "launches": {arch: m["serve_path_launches"]["K2"]
                         for arch, m in rec_models.items()},
            "launches_per_prefill": {
                arch: m["serve"]["float32"]["launches_prefill"]["served"][
                    "K2"] for arch, m in rec_models.items()},
            "launches_per_decode_step": {
                arch: m["serve"]["float32"]["launches_decode_step"][
                    "served"]["K2"] for arch, m in rec_models.items()},
            "export_path_launches": {
                arch: {st: v["K2"] for st, v in
                       m["launches_per_stage"].items()}
                for arch, m in rec_models.items()},
            "engine_launches": rec_models[LM_RECURRENT[0]]["engine"][
                "launches"]["K2"],
            "shapes": rec_k2_rows,
        },
        "lm_encdec": {
            "scope": f"[lm-encdec]: {ENCDEC_ARCH} at full width; shapes: "
                     f"its (K, N) pairs at M = "
                     f"{ENCDEC_REQUESTS * ENCDEC_FRAMES} (encoder), "
                     f"{ENCDEC_REQUESTS * ENCDEC_PROMPT_LEN} (decoder "
                     f"prefill) and {ENCDEC_REQUESTS} (decode), float32 X, "
                     "timed as the [lm] rows; launches: the served float32 "
                     "warm-up, timed and code-recording prefill and decode "
                     "runs (counts set to 0 before, read after)",
            "launches": encdec["serve_path_launches"]["K2"],
            "launches_per_prefill": encdec["serve"]["launches_prefill"][
                "served"]["K2"],
            "launches_per_decode_step": encdec["serve"][
                "launches_decode_step"]["served"]["K2"],
            "export_path_launches": {st: v["K2"] for st, v in
                                     encdec["launches_per_stage"].items()},
            "shapes": encdec_k2_rows,
        },
        "lm_scan": {
            "scope": f"[lm-scan]: ScanTarget on {SCAN_ARCH} at full width "
                     "and depth (per-layer k from the ladder by activity "
                     "rank); launches: the served float32 warm-up and timed "
                     "prefill and decode runs (counts set to 0 before, read "
                     f"after), one a matmul: {SCAN_UNITS} a forward",
            "launches": scan["serve_path_launches"]["K2"],
            "launches_per_prefill": scan["serve"]["launches_prefill"][
                "served"]["K2"],
            "launches_per_decode_step": scan["serve"][
                "launches_decode_step"]["served"]["K2"],
            "export_path_launches": {st: v["K2"] for st, v in
                                     scan["launches_per_stage"].items()},
        },
        "lm_moe": {
            "scope": f"[lm-moe]: MoETarget on {MOE_ARCH} at full width, "
                     f"{MOE_LAYERS} layers; shapes: one LUT GEMM an (expert, "
                     f"matrix) at M = {LM_PROMPTS} x the expert capacity "
                     "(prefill of 256 tokens: 40; decode: 8), float32 X, "
                     "timed as the [lm] rows; launches: the served float32 "
                     "warm-up, timed and code-recording prefill and decode "
                     "runs (counts set to 0 before, read after), one an "
                     f"(expert, matrix) and one an attention matmul: "
                     f"{MOE_UNITS_A_LAYER} a layer a forward",
            "launches": moe["serve_path_launches"]["K2"],
            "launches_per_prefill": moe["serve"]["launches_prefill"][
                "served"]["K2"],
            "launches_per_decode_step": moe["serve"][
                "launches_decode_step"]["served"]["K2"],
            "export_path_launches": {st: v["K2"] for st, v in
                                     moe["launches_per_stage"].items()},
            "shapes": moe_k2_rows,
        },
        "lm_vlm": {
            "scope": f"[lm-vlm]: {VLM_ARCH} at full width, {VLM_LAYERS} of "
                     "its 48 layers; shapes: its (K, N) pairs at M = "
                     f"{LM_PROMPTS} x (256 patches + {LM_PROMPT_LEN} "
                     f"tokens) (prefill) and {LM_PROMPTS} (decode), float32 "
                     "X, timed as the [lm] rows; launches: the served "
                     "float32 warm-up, timed and code-recording prefill and "
                     "decode runs (counts set to 0 before, read after), "
                     f"one a matmul: {7 * VLM_LAYERS} a forward",
            "launches": vlm["serve_path_launches"]["K2"],
            "launches_per_prefill": vlm["serve"]["launches_prefill"][
                "served"]["K2"],
            "launches_per_decode_step": vlm["serve"][
                "launches_decode_step"]["served"]["K2"],
            "export_path_launches": {st: v["K2"] for st, v in
                                     vlm["launches_per_stage"].items()},
            "shapes": vlm_k2_rows,
        },
    }
    k1_entry = {
        **K1, "route": "cuda", "launches": k1_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        **{key: sum(r[key] for r in k1_path)
           for key in ("ms", "plain_ms", "device_ms", "bound_ms")},
        "bound_by": "operations"
        if all(r["bound_by"] == "operations" for r in k1_path) else "bytes",
        "library_ms": None,
        "library": "none: no PyTorch call computes these statistics",
        "scope": f"sum over the {k1_launches} launches of one ResNet-20 "
                 f"profile stage at batch {BATCH} ({PROFILE_TILES} tiles a "
                 "layer, T = 64), timed on the stage's own tiles: ms, "
                 "plain_ms one call between CUDA events, the card idle "
                 "before it; device_ms one launch's device time in a CUDA "
                 "graph",
        "compress_path_launches": compress_launches["K1"],
        "table1_launches": table1["launches"]["K1"],
        "cosim": {
            "scope": "[cosim]: the ResNet-20 profile stage with "
                     "profile.verify_cosim (launches: 22 for the statistics "
                     "and 22 for the check, in the pipeline and again "
                     "through the CLI), then K1 against the bit-accurate "
                     "systolic cosim on the K1 phase's cases and a T sweep: "
                     "k1_ms one call between CUDA events, cosim_s the "
                     "cosim's host time for the same tiles",
            "profile_launches": cosim["profile"]["pipeline"]["k1_launches"],
            "cli_launches": cosim["profile"]["cli"]["k1_launches"],
            "cosim_tiles": cosim["profile"]["pipeline"]["cosim_tiles"],
            "cases": cosim["cases"],
        },
        "main_path": k1_path,
        "shapes": k1_rows,
    }
    k1b = next(r for r in k1_rows if r["case"].startswith("K1b"))
    k1b_entry = {
        "name": "transition_energy (K1b, one tile)", "route": "cuda",
        "source": K1["source"], "replaces": K1B_REPLACES, "launches": 0,
        **{key: k1b[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "device_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        "scope": "one tile, T = 64, as a batch of one over K1 "
                 "(ops.tile_transition_stats); no path of the pipeline "
                 "calls the tile API, so it has no launches there",
    }
    k3_all = k3_rows + k3_group_rows + k3_cand_rows
    k3_entry = {
        **K3, "route": "cuda", "launches": compress_launches["K3"],
        "max_abs_err": max([r["max_abs_err"] for r in k3_all]
                           + [lm_k3["max_abs_err"]]
                           + [r["max_abs_err"] for rows in rec_k3.values()
                              for r in rows]
                           + [encdec_k3["max_abs_err"],
                              moe_k3["max_abs_err"]]),
        "ms": k3_forward["device_ms"], "plain_ms": k3_forward["plain_ms"],
        "bound_ms": k3_forward["bound_ms"],
        "bound_by": k3_forward["bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes this function",
        "scope": "one grouped launch: the 22 weights of a ResNet-20 QAT "
                 "forward (k = 16, 50% mask), scale and straight-through "
                 "value inside, device time in a CUDA graph (`timing`); "
                 "per_layer_*: the per-layer path on the same weights in the "
                 "same run; candidate_axis: one launch of n candidates of "
                 "those 22 weights (every field per candidate) beside n "
                 "single-candidate launches; launches: the compress path's "
                 "run under the default (batched) search mode, "
                 "candidate_axis_launches those of them with a candidate "
                 "axis, "
                 "compress_path_serial_launches under the serial walk, "
                 "sweep_launches the sweep phase's schedule stage",
        **{key: k3_forward[key] for key in (
            "timing", "host_us_per_call", "per_layer_kernels_device_ms",
            "per_layer_chains_device_ms", "per_layer_chains_host_us",
            "weights")},
        "launches_per_stage": {stage: v["K3"]
                               for stage, v in compress_stages.items()},
        "candidate_axis_launches": sum(f["candidates"]
                                       for f in compress_fwds.values()),
        "compress_path_serial_launches": serial_launches["K3"],
        "sweep_launches": {mode: r["k3_launches"]
                           for mode, r in sweep["runs"].items()},
        "candidate_axis": k3_cand,
        "cases_equal": len(k3_all),
        "lm": dict(lm_k3, scope=f"{LM_ARCH} at full width: the one grouped "
                   "launch of a fake-quant forward, its stacked units as "
                   "entries and the layer axis as candidates",
                   launches=lm["serve_path_launches"]["K3"],
                   launches_per_forward=lm["serve"]["float32"][
                       "launches_prefill"]["fake_quant"]["K3"],
                   export_path_launches={st: v["K3"] for st, v in
                                         lm["launches_per_stage"].items()},
                   engine=dict(
                       scope="[lm-engine] (a): the pipeline's serve stage "
                             "(the fake-quant engine, then the oneshot "
                             f"fallback) on {LM_ARCH} at full width; one "
                             "launch a forward call",
                       launches=lm["engine"]["stage"]["launches"]["K3"],
                       forward_calls=lm["engine"]["stage"]["forward_calls"],
                       lut_engine_launches={
                           mode: r["launches"]["K3"] for mode, r in
                           lm["engine"]["lut"]["runs"].items()}),
                   fleet=dict(
                       scope="[lm-fleet]: the fleet router over base / k8 / "
                             f"k4 of {LM_ARCH} at full width, "
                             f"{LM_FLEET_LAYERS} layers, with fake-quant "
                             "engines, burst then trickle; launches: that "
                             "run, one a forward call of a compressed "
                             "plan's engine",
                       launches=lm["fleet"]["fake_quant"]["launches"]["K3"],
                       per_plan={pid: c["K3"] for pid, c in
                                 lm["fleet"]["fake_quant"]["per_plan"]
                                 .items()},
                       forward_calls={pid: c["forward_calls"] for pid, c in
                                      lm["fleet"]["fake_quant"]["per_plan"]
                                      .items()},
                       lut_fleet_launches=lm["fleet"]["lut"]["launches"][
                           "K3"]),
                   train=dict(
                       scope="[lm-train]: repro_torch.launch.train.main, "
                             f"{LM_ARCH} at full width, {LM_TRAIN_STEPS} "
                             f"QAT steps at batch {LM_TRAIN_BATCH} x 64; "
                             "launches: that run, one a forward (a step)",
                       launches=lm_train["train"]["k3_launches"],
                       forward_calls=lm_train["train"]["forward_calls"],
                       steps=LM_TRAIN_STEPS,
                       step_ms=lm_train["train"]["median_step_ms"],
                       parity=lm_train_parity)),
        "lm_recurrent": dict(
            scope="[lm-recurrent]: mamba2-1.3b (one launch a fake-quant "
                  "forward: 2 units x 48 layers as candidates) and "
                  "recurrentgemma-2b (two: 23 stacked units x 8 layers, then "
                  "the tail's 16 units) at full width; groups: each launch "
                  "held against its plain version bit for bit and timed "
                  "between CUDA events beside its bound; launches: the "
                  "fake-quant float32 and bfloat16 prefill and decode runs, "
                  "the engine stage on mamba2's plan, and the CLI's QAT "
                  "steps",
            groups=rec_k3,
            launches={arch: m["serve_path_launches"]["K3"]
                      for arch, m in rec_models.items()},
            launches_per_forward={
                arch: m["serve"]["float32"]["launches_prefill"][
                    "fake_quant"]["K3"] for arch, m in rec_models.items()},
            engine_launches=rec_models[LM_RECURRENT[0]]["engine"][
                "launches"]["K3"],
            engine_forward_calls=rec_models[LM_RECURRENT[0]]["engine"][
                "forward_calls"],
            train_launches=recurrent["train"]["k3_launches"],
            train_forward_calls=recurrent["train"]["forward_calls"]),
        "lm_encdec": dict(
            encdec_k3,
            scope=f"[lm-encdec]: {ENCDEC_ARCH} at full width, the one "
                  "grouped launch of a fake-quant forward (the decoder's 10 "
                  "and the encoder's 6 stacked units, 32 layers as "
                  "candidates), held against its plain version bit for bit "
                  "and timed between CUDA events beside its bound; "
                  "launches: the fake-quant float32 warm-up and timed "
                  f"prefill and decode runs, then {ENCDEC_TRAIN_STEPS} QAT "
                  "steps",
            launches=encdec["serve_path_launches"]["K3"],
            launches_per_forward=encdec["serve"]["launches_prefill"][
                "fake_quant"]["K3"],
            train_launches=encdec["train"]["k3_launches"]),
        "table1": dict(
            scope="[table1]: ResNet-20's Table 1 rows (the QAT, the "
                  "PowerPruning fine-tune, the schedule); launches: that "
                  "phase",
            launches=table1["launches"]["K3"]),
        "lm_scan": dict(
            scope=f"[lm-scan]: ScanTarget on {SCAN_ARCH} at full width and "
                  "depth, one launch a fake-quant forward (2 units x 48 "
                  "layers as candidates, each layer its own k); launches: "
                  "the fake-quant float32 warm-up and timed prefill and "
                  "decode runs, then the pipeline's serve stage (one a "
                  "forward call)",
            launches=scan["serve_path_launches"]["K3"],
            launches_per_forward=scan["serve"]["launches_prefill"][
                "fake_quant"]["K3"],
            export_path_launches={st: v["K3"] for st, v in
                                  scan["launches_per_stage"].items()},
            stage_launches=scan["stage"]["launches"]["K3"],
            stage_forward_calls=scan["stage"]["forward_calls"]),
        "lm_moe": dict(
            moe_k3,
            scope=f"[lm-moe]: MoETarget on {MOE_ARCH} at full width, "
                  f"{MOE_LAYERS} layers: the one grouped launch of a "
                  "fake-quant forward (4 attention units with the layers as "
                  "candidates, 3 expert units with layers x 16 experts: "
                  "each expert its own scales and codebook), held against "
                  "its plain version bit for bit and timed between CUDA "
                  "events beside its bound; launches: the fake-quant "
                  "float32 warm-up and timed prefill and decode runs, then "
                  "the serve stage's engine (one a forward call)",
            launches=moe["serve_path_launches"]["K3"],
            launches_per_forward=moe["serve"]["launches_prefill"][
                "fake_quant"]["K3"],
            export_path_launches={st: v["K3"] for st, v in
                                  moe["launches_per_stage"].items()},
            engine_launches=moe["engine"]["launches"]["K3"],
            engine_forward_calls=moe["engine"]["forward_calls"]),
        "lm_vlm": dict(
            vlm_k3,
            scope=f"[lm-vlm]: {VLM_ARCH} at full width, {VLM_LAYERS} "
                  "layers: the one grouped launch of a fake-quant forward "
                  f"(7 stacked units, {VLM_LAYERS} layers as candidates), "
                  "held against its plain version bit for bit and timed "
                  "between CUDA events beside its bound; launches: the "
                  "fake-quant float32 warm-up and timed prefill and decode "
                  f"runs, then the QAT step at {VLM_TRAIN_LAYERS} layers",
            launches=vlm["serve_path_launches"]["K3"],
            launches_per_forward=vlm["serve"]["launches_prefill"][
                "fake_quant"]["K3"],
            export_path_launches={st: v["K3"] for st, v in
                                  vlm["launches_per_stage"].items()},
            train_launches=vlm["train"]["k3_launches"]),
    }
    mesh = dict(profile=mesh_prof, sweep=sweep["mesh"],
                engine=lm["engine"]["lut"]["mesh"], fleet=lm["fleet"]["mesh"])
    mesh_s = {"profile": mesh_prof["phase_s"],
              "sweep": sweep["mesh"]["wall_s_schedule"],
              "engine": mesh["engine"]["run_s"],
              "fleet": mesh["fleet"]["phase_s"]}
    print(f"[mesh] {sum(mesh_s.values()):.1f} s "
          + json.dumps(mesh_s, sort_keys=True)
          + f"; [fault] {fault['phase_s']:.1f} s", flush=True)
    k1_entry["mesh"] = dict(
        scope="[mesh] profile: the ResNet-20 profile stage with profile_mesh "
              f"on cuda:0 (one launch a shard a layer), and the "
              f"{mesh_prof['all_tiles']['tiles']}-tile stage-1 conv over "
              f"{MESH_SHARDS} shards",
        launches={k: r["k1_launches"]
                  for k, r in mesh_prof["runs"].items()},
        all_tiles=mesh_prof["all_tiles"])
    k2_entry["mesh"] = dict(
        scope=f"[mesh] engine and fleet: {LM_ARCH}'s wave engine (the "
              f"[lm-engine] (b) requests, {LM_ENGINE_LAYERS} layers) and the "
              "[lm-fleet] LUT fleet in "
              f"wave mode on a {MESH_REQUEST_SHARDS}-shard request mesh on "
              "cuda:0, each shard's rows one launch a matmul",
        engine_launches=mesh["engine"]["k2_launches"],
        engine_launches_unsharded=mesh["engine"]["k2_launches_unsharded"],
        fleet_launches=mesh["fleet"]["k2_launches"],
        fleet_launches_unsharded=mesh["fleet"]["k2_launches_unsharded"])
    k3_entry["mesh"] = dict(
        scope=f"[mesh] sweep: the [sweep] schedule stage under the batched "
              f"sweep with a {MESH_SHARDS}-shard sweep_mesh on cuda:0 (one "
              "launch a shard a forward)",
        launches=sweep["mesh"]["k3_launches"],
        forwards=sweep["mesh"]["forwards"])
    k3_entry["fault"] = dict(
        scope="[fault]: run_resilient_loop over ResNet-20 QAT steps, "
              f"faults at {list(FAULT_AT)} (one launch a step, replays "
              "included), then the int8-compressed AdamW steps",
        launches=fault["k3_launches"],
        compression_launches=fault["compression"]["k3_launches"])
    k3_entry["mesh2d"] = dict(
        scope=f"[mesh2d]: {LM_ARCH}'s QAT step with mesh= and rules=, "
              f"{MESH2D_STEPS} steps at {MESH2D_BATCH} x {MESH2D_TOKENS} "
              "tokens; (a) a 1 x 1 mesh over NCCL, full depth; (b) a "
              f"{'x'.join(map(str, MESH2D_SHAPE))} mesh of four processes "
              f"on cuda:0 (gloo), {MESH2D_LAYERS} layers, tensor-parallel "
              "over 'model', the one grouped launch on each rank's slices "
              "with the gathered weights' scales (FSDP a layer); launches "
              "a step (counts set to 0 before each step, read after), "
              "each rank",
        one_by_one=mesh2d["one"]["k3_launches_per_step"],
        ranks={lr: {r["rank"]: r["k3_launches_per_step"]
                    for r in run["ranks"]}
               for lr, run in mesh2d["two"]["runs"].items()},
        moe=dict(
            scope=f"(c): {MESH2D_MOE_ARCH} at full width, "
                  f"{MESH2D_MOE_LAYERS} layer, a "
                  f"{'x'.join(map(str, MESH2D_MOE_SHAPE))} mesh of four "
                  "processes on cuda:0, expert parallel: the one grouped "
                  "launch on each rank's 4 experts; launches a step, each "
                  "rank, and the unmeshed reference's on rank 0",
            ranks={r["rank"]: r["k3_launches_per_step"]
                   for r in mesh2d["moe"]["ranks"]},
            unmeshed=mesh2d["moe"]["ref_k3_launches_per_step"]))
    entries = [k2_entry, k1_entry, k1b_entry, k3_entry]
    print("[mesh] " + json.dumps({
        "profile_all_tiles": mesh_prof["all_tiles"],
        "sweep_trials_per_s": sweep["mesh"]["trials_per_s"],
        "engine": {k: mesh["engine"][k] for k in (
            "tokens_equal", "logits_equal", "k2_launches_per_step",
            "k2_launches_per_step_unsharded", "tokens_per_s",
            "tokens_per_s_unsharded")},
        "fleet": {k: mesh["fleet"][k] for k in (
            "route_log_equal", "tokens_equal", "tokens_per_s",
            "tokens_per_s_unsharded")}}, sort_keys=True), flush=True)
    print(f"[card] {card}", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
