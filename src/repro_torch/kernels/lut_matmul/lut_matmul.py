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

A launch takes a configuration, `K2Config`: the tile (``block_m``,
``block_n``) from the kernel's table `TILES` and the weight's ``dequant``,
``"prepass"`` (a pre-pass kernel writes the float64 weight into a scratch
that `launch` allocates) or ``"tile"`` (formed inside the GEMM, no scratch).
Every configuration gives the same output bit for bit. `default_config`
is the kernel's choice from N alone, what `launch` runs without one;
`repro_torch.kernels.lut_matmul.autotune` chooses among all of them.

``launches`` counts kernel launches (one per `launch` call that reached the
device, the pre-pass not counted), and ``configs`` the launches a
configuration, so a run can show that its main path went through the kernel
and which configurations it took.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._build import KernelLibrary
from repro_torch.kernels.lut_matmul.ref import N_CODES

# the keys of ref.ACTIVATIONS, coded as csrc's `activate` expects them
ACT_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}

SOURCE = Path(__file__).resolve().parent / "csrc" / "lut_matmul.cu"
LIBRARY = KernelLibrary(
    "lut_matmul", SOURCE,
    {"lut_matmul_launch": ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                           + [ctypes.c_int] * 11),
     "lut_matmul_config": [ctypes.c_int] * 5 + [ctypes.c_void_p],
     "lut_matmul_scratch_doubles": [ctypes.c_int] * 3})
X_ALIGN = 8        # K_x % X_ALIGN == 0: 16-byte rows for the kernel's copies
CONFIG_FIELDS = ("mma_m", "mma_n", "mma_k", "stages", "block_m", "block_n",
                 "block_k", "warp_m", "warp_n", "threads", "registers",
                 "spill_bytes", "smem_bytes", "blocks_per_sm", "sms")

# the kernel's tile table (csrc's `with_tile`): (BM, BN) -> warp tile (WM, WN)
TILES = {(128, 16): (32, 16), (128, 32): (32, 32), (64, 64): (32, 32),
         (32, 16): (32, 8), (32, 32): (32, 8), (32, 64): (32, 8),
         (16, 16): (16, 8), (16, 32): (16, 8), (16, 64): (16, 8)}
DEQUANT = ("prepass", "tile")
KC = 32            # K rows a ring stage (csrc's kKC)
STAGES = 4         # ring depth (csrc's kStages)

launches = 0       # kernel launches in this process
configs = collections.Counter()   # K2Config -> launches
_SCRATCH = {}      # (K_x, N, BN) -> doubles of weight scratch a pre-pass needs


@dataclasses.dataclass(frozen=True)
class K2Config:
    """One launch configuration: the block tile and where the weight is
    dequantized (`DEQUANT`)."""

    block_m: int
    block_n: int
    dequant: str = "prepass"

    def __post_init__(self):
        if (self.block_m, self.block_n) not in TILES:
            raise ValueError(f"tile ({self.block_m}, {self.block_n}) is not "
                             f"in the kernel's table {sorted(TILES)}")
        if self.dequant not in DEQUANT:
            raise ValueError(f"dequant must be one of {DEQUANT}, got "
                             f"{self.dequant!r}")

    @property
    def warp(self):
        return TILES[self.block_m, self.block_n]

    @property
    def threads(self) -> int:
        wm, wn = self.warp
        return self.block_m // wm * (self.block_n // wn) * 32

    def smem_bytes(self, x_dtype=torch.float32) -> int:
        """Dynamic shared memory a block (csrc's ``Tile<...>::kSmem`` /
        ``kSmemTile``): the X ring, rows padded by 16 bytes, and the float64
        weight ring, rows padded by 4 doubles ("prepass"), or the packed
        byte ring, rows padded by 16 bytes ("tile")."""
        size = torch.empty((), dtype=x_dtype).element_size()
        x_ring = STAGES * self.block_m * (KC + 16 // size) * size
        if self.dequant == "tile":
            return x_ring + STAGES * KC * (self.block_n + 16)
        return x_ring + STAGES * KC * (self.block_n + 4) * 8

    def to_json(self) -> list:
        return [self.block_m, self.block_n, self.dequant]

    @classmethod
    def from_json(cls, v) -> "K2Config":
        return cls(int(v[0]), int(v[1]), str(v[2]))

    def __str__(self) -> str:
        return f"{self.block_m}x{self.block_n}/{self.dequant}"


def tile_dequant_legal(n: int, pack_block: int) -> bool:
    """Whether "tile" dequant takes an (N, pack_block) problem: it copies
    16-byte pieces of packed rows (N % 16 == 0) and reads one nibble a
    32-row chunk (pack_block % 64 == 0)."""
    return n % 16 == 0 and pack_block % 64 == 0


def default_config(n: int) -> K2Config:
    """The kernel's choice from the output width alone (no tuner): one tile
    column up to N = 64 (BN 16, 32 or 64), BM 128 for N <= 32 and 64 above,
    the pre-pass."""
    bn = 16 if n <= 16 else 32 if n <= 32 else 64
    return K2Config(128 if bn <= 32 else 64, bn, "prepass")


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
           activation: str = "none", pack_block: int = 128,
           config: Optional[K2Config] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors already validated by `check_inputs`
    (use `repro_torch.kernels.lut_matmul.ops.lut_matmul_fused`) in
    ``config`` (`default_config` of N when None). Returns the float32 (M, N)
    output; raises `RuntimeError` if the launch failed (no other
    configuration is tried). The float64 weight scratch of a pre-pass
    configuration is allocated here."""
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
    if config is None:
        config = default_config(n)
    if config.dequant == "tile" and not (tile_dequant_legal(n, pack_block)
                                         and packed.data_ptr() % 16 == 0):
        raise ValueError(f"{config} needs N % 16 == 0, pack_block % 64 == 0 "
                         f"and 16-byte-aligned packed rows; got N={n}, "
                         f"pack_block={pack_block}")
    lib = LIBRARY.load()
    scratch, n_scratch = None, 0
    if config.dequant == "prepass":
        key = (k, n, config.block_n)
        n_scratch = _SCRATCH.get(key)
        if n_scratch is None:
            n_scratch = _SCRATCH[key] = lib.lut_matmul_scratch_doubles(*key)
        if n_scratch < 0:
            raise ValueError(f"K_x={k} x N={n} needs more weight scratch "
                             "than the kernel addresses")
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
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        stream, n_scratch, index, m, k, 2 * k2, n, pack_block,
        ACT_CODES[activation], x.dtype == torch.bfloat16, config.block_m,
        config.block_n, int(config.dequant == "tile"))
    if err != 0:
        raise RuntimeError(f"lut_matmul kernel launch failed: CUDA error {err} "
                           f"at M={m} K_x={k} N={n} in {config}")
    launches += 1
    configs[config] += 1
    return out


def config(cfg: K2Config, x_dtype=torch.float32, device: int = 0) -> dict:
    """What the kernel of configuration ``cfg`` is on a card:
    `CONFIG_FIELDS` (MMA shape, ring stages, block and warp tiles, threads,
    registers and spill bytes a thread, dynamic shared memory a block,
    resident blocks per SM, SMs)."""
    info = (ctypes.c_int * len(CONFIG_FIELDS))()
    err = LIBRARY.load().lut_matmul_config(
        cfg.block_m, cfg.block_n, int(cfg.dequant == "tile"),
        int(x_dtype == torch.bfloat16), device, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"lut_matmul_config failed: CUDA error {err}")
    return dict(zip(CONFIG_FIELDS, info))
