"""Build, load and launch the CUDA LUT-GEMM kernel (``csrc/lut_matmul.cu``).

The kernel replaces the TPU kernel
``repro.kernels.lut_matmul.lut_matmul.lut_matmul_pallas``; the source's
header says what bounds it on an H100 and how its design responds.

The source compiles at first use with ``nvcc`` for ``sm_90a`` into
``build/lut_matmul/`` at the repository root and is loaded with `ctypes`
(`repro_torch.kernels._build`). Nothing here runs at import: the CPU tests
import this module on hosts without ``nvcc`` or a GPU.

X is (M, K_x), unpadded: K_x is a multiple of `X_ALIGN` (so every row is
16-byte aligned in float32 and bfloat16) and at most K_pad = 2 * packed
rows, rounded up to `X_ALIGN`; the kernel never reads columns past K_x, and
treats weight rows past K_pad as zero. The serve path builds rows
``round_up(K, X_ALIGN)`` wide (`x_width`).

``launches`` counts kernel launches (one per `launch` call that reached the
device), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary
from repro_torch.kernels.lut_matmul.ref import N_CODES

# the keys of ref.ACTIVATIONS, coded as csrc's `activate` expects them
ACT_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}

SOURCE = Path(__file__).resolve().parent / "csrc" / "lut_matmul.cu"
LIBRARY = KernelLibrary(
    "lut_matmul", SOURCE,
    {"lut_matmul_launch": ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                           + [ctypes.c_int] * 8),
     "lut_matmul_config": [ctypes.c_int] * 3 + [ctypes.c_void_p],
     "lut_matmul_scratch_doubles": [ctypes.c_int] * 2})
X_ALIGN = 8        # K_x % X_ALIGN == 0: 16-byte rows for the kernel's copies
CONFIG_FIELDS = ("mma_m", "mma_n", "mma_k", "stages", "block_m", "block_n",
                 "block_k", "warp_m", "warp_n", "threads", "registers",
                 "spill_bytes", "smem_bytes", "blocks_per_sm", "sms")

launches = 0       # kernel launches in this process
_SCRATCH = {}      # (K_x, N) -> doubles of weight scratch a launch needs


def x_width(k: int) -> int:
    """Columns of the X rows the serve path builds for reduction size K."""
    return -(-k // X_ALIGN) * X_ALIGN


def check_inputs(x, packed, codebook, scale, bias, residual, activation,
                 pack_block) -> None:
    """Raise `ValueError` on anything the kernel does not take: the bad
    shapes of the TPU kernel's `_check_blocks`, plus device, dtype and
    contiguity (the kernel reads raw row-major memory, so a strided view is
    refused rather than copied behind the caller's back)."""
    if x.ndim != 2 or packed.ndim != 2:
        raise ValueError(f"x and packed must be 2-D, got {tuple(x.shape)} and "
                         f"{tuple(packed.shape)}")
    m, k = x.shape
    k2, n = packed.shape
    if k > x_width(2 * k2):
        raise ValueError(
            f"packed shape {(k2, n)} does not pair with x shape {(m, k)}: "
            f"need K_x <= K_pad = 2 * packed rows, got K_x={k} vs {2 * k2}")
    if k % X_ALIGN:
        raise ValueError(
            f"K_x={k} must be a multiple of {X_ALIGN} (16-byte rows); build "
            f"X rows round_up(K, {X_ALIGN}) wide with zeros past K")
    if pack_block % 2 != 0 or pack_block < 2:
        raise ValueError(f"pack_block must be a positive even int, "
                         f"got {pack_block}")
    if (2 * k2) % pack_block:
        raise ValueError(
            f"K_pad={2 * k2} must be a multiple of pack_block={pack_block} "
            "(packing is block-local; pad K at export)")
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"expected one of {sorted(ACT_CODES)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    dev = x.device
    if not x.is_contiguous():
        raise ValueError("x must be contiguous row-major; build it "
                         "contiguous (no strided views)")
    for name, t, dtype, shape in (
            ("packed", packed, torch.int8, (k2, n)),
            ("codebook", codebook, torch.int8, (N_CODES,)),
            ("scale", scale, torch.float32, (n,)),
            ("bias", bias, torch.float32, (n,)),
            ("residual", residual, torch.float32, (m, n))):
        if t is None:
            continue
        if t.shape != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous row-major; build it "
                             "contiguous (no strided views)")


def launch(x, packed, codebook, scale, *, bias=None, residual=None,
           activation: str = "none", pack_block: int = 128) -> torch.Tensor:
    """Launch the kernel on CUDA tensors already validated by `check_inputs`
    (use `repro_torch.kernels.lut_matmul.ops.lut_matmul_fused`). Returns the
    float32 (M, N) output; raises `RuntimeError` if the launch failed. The
    float64 weight scratch of its dequant pre-pass is allocated here."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    xp = x.data_ptr()
    if xp % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernel "
                         "copies 16-byte row pieces)")
    m, k = x.shape
    k2, n = packed.shape
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    lib = LIBRARY.load()
    n_scratch = _SCRATCH.get((k, n))
    if n_scratch is None:
        n_scratch = _SCRATCH[k, n] = lib.lut_matmul_scratch_doubles(k, n)
    if n_scratch < 0:
        raise ValueError(f"K_x={k} x N={n} needs more weight scratch than "
                         "the kernel addresses")
    scratch = torch.empty(n_scratch, dtype=torch.float64, device=dev)
    index = dev.index or 0
    # the raw cudaStream_t of PyTorch's current stream (what
    # torch.cuda.current_stream(dev).cuda_stream returns, without building a
    # Stream object on every launch)
    stream = torch._C._cuda_getCurrentRawStream(index)
    err = lib.lut_matmul_launch(
        xp, packed.data_ptr(), codebook.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), stream, n_scratch, index, m, k,
        2 * k2, n, pack_block, ACT_CODES[activation],
        x.dtype == torch.bfloat16)
    if err != 0:
        raise RuntimeError(f"lut_matmul kernel launch failed: CUDA error {err} "
                           f"at M={m} K_x={k} N={n}")
    launches += 1
    return out


def config(n: int, x_dtype=torch.float32, device: int = 0) -> dict:
    """The kernel configuration that serves output width ``n`` on a card:
    `CONFIG_FIELDS` (MMA shape, ring stages, block and warp tiles, threads,
    registers and spill bytes a thread, dynamic shared memory a block,
    resident blocks per SM, SMs)."""
    info = (ctypes.c_int * len(CONFIG_FIELDS))()
    err = LIBRARY.load().lut_matmul_config(
        n, int(x_dtype == torch.bfloat16), device, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"lut_matmul_config failed: CUDA error {err}")
    return dict(zip(CONFIG_FIELDS, info))
