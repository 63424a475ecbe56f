"""Compressed serving export: post-schedule comp tree -> packed artifacts.

Port of `repro.core.export`. Per compressed layer, deployment stores only
what the systolic array needs:

  * ``packed``    (K_pad//2, N) int8 — 4-bit codebook indices, two K rows per
                  byte in the block-local layout of `pack_indices`,
  * ``codebook``  (16,) int8 — the layer's restricted weight set,
  * ``scale``     (N,) float32 — per-output-channel symmetric dequant scale.

`export_layer` follows `qat.fake_quant_weight` step for step, so the served
weights dequantize to the fake-quant weights (pruned positions always serve
as exact 0). The artifacts are byte-identical to the JAX package's export of
the same weights and comp state.

The serve forwards hand the kernel row-major contiguous ``(M, K_x)``
activations, ``K_x = round_up(K, 8)`` (`ServeArtifact.k_x`; the kernel never
reads the pack block's padding), and ``(M, N)`` residuals, built so
explicitly: the kernel's wrapper refuses strided views instead of copying
them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import qat
from repro_torch.core.layer_energy import MatmulDims, dense_matmul_dims
from repro_torch.core.stats import conv_out_hw, im2col_rows
from repro_torch.kernels.lut_matmul.lut_matmul import x_width
from repro_torch.kernels.lut_matmul.ops import (
    N_CODES,
    compress_layer_weights,
    lut_matmul_fused,
)


@dataclasses.dataclass
class ServeArtifact:
    """Packed 4-bit serving form of one compressed matmul weight."""

    packed: torch.Tensor     # (K_pad//2, N) int8
    codebook: torch.Tensor   # (16,) int8
    scale: torch.Tensor      # (N,) float32
    k_dim: int               # unpadded reduction dim (= X's contraction size)
    n_dim: int               # output channels
    block_k: int
    kind: str = "dense"      # "dense" | "conv"
    kernel: int = 1          # conv spatial kernel size (1 for dense)

    @property
    def weight_bytes(self) -> int:
        """Serving footprint: packed nibbles + codebook + f32 scales."""
        return int(self.packed.numel() + self.codebook.numel()
                   + self.scale.numel() * 4)

    @property
    def dense_bytes_int8(self) -> int:
        """What the same (unpadded) weight costs stored as plain int8."""
        return int(self.k_dim * self.n_dim)

    @property
    def k_pad(self) -> int:
        return 2 * int(self.packed.shape[0])

    @property
    def k_x(self) -> int:
        """Width of the X rows the serve forwards feed the kernel."""
        return x_width(self.k_dim)

    def matmul_dims(self, n_tokens: int) -> MatmulDims:
        """Systolic mapping of this artifact's GEMM for ``n_tokens`` streamed
        columns."""
        return dense_matmul_dims(fan_in=self.k_dim, fan_out=self.n_dim,
                                 n_tokens=n_tokens)

    def to(self, device) -> "ServeArtifact":
        return dataclasses.replace(self, packed=self.packed.to(device),
                                   codebook=self.codebook.to(device),
                                   scale=self.scale.to(device))


def servable(comp: qat.CompState) -> bool:
    """A layer can take the 4-bit LUT path iff its restriction is active and
    fits the 16-entry hardware codebook."""
    k = int(comp["codebook_k"])
    return 0 < k <= N_CODES


def _weight_matrix(qp: torch.Tensor, scale: torch.Tensor, layout: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weights + keepdims scale -> ((K, N) matrix, (N,) scale)."""
    scale_full = torch.broadcast_to(scale, qp.shape)
    if layout == "out_last":
        mat = qp.reshape(-1, qp.shape[-1])
        scale_n = scale_full.reshape(-1, qp.shape[-1])[0]
    elif layout == "in_first":
        mat = qp.reshape(qp.shape[0], -1)
        scale_n = scale_full[0].reshape(-1)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    return mat, scale_n


def export_layer(w: torch.Tensor, comp: qat.CompState, *, kind: str = "dense",
                 layout: str = "out_last",
                 block_k: int = 128) -> Optional[ServeArtifact]:
    """Export one compressed weight tensor; None if it is not servable."""
    if not servable(comp):
        return None
    if kind == "conv" and w.shape[0] != w.shape[1]:
        raise ValueError(
            f"serve_conv assumes square conv kernels, got {tuple(w.shape[:2])}")
    k_valid = int(comp["codebook_k"])
    values = sorted({int(v) for v in comp["codebook"][:k_valid].tolist()})

    # the training scale reduces over all axes but the last of the original
    # tensor; reshape weight/mask/scale to the (K, N) serving layout
    mask = comp["mask"].to(w.dtype)
    scale = qat.weight_scale(w * mask)                # keepdims, per out chan
    w_mat, scale_n = _weight_matrix(w, scale, layout)
    mask_mat, _ = _weight_matrix(mask, scale, layout)
    msr = comp.get("msr_bits")
    packed, cb, scale_n = compress_layer_weights(
        w_mat, values, mask=mask_mat, scale=scale_n,
        msr_bits=0 if msr is None else int(msr), block_k=block_k, pad_k=True)

    k_dim, n_dim = w_mat.shape
    return ServeArtifact(packed=packed, codebook=cb,
                         scale=scale_n.to(torch.float32).contiguous(),
                         k_dim=int(k_dim), n_dim=int(n_dim), block_k=block_k,
                         kind=kind,
                         kernel=int(w.shape[0]) if kind == "conv" else 1)


def export_model(model, params, comp: Dict[str, qat.CompState], *,
                 block_k: int = 128) -> Dict[str, ServeArtifact]:
    """Export every servable compressible layer of a `CNNModel`. Layers that
    are not servable are absent: they serve on fake-quant."""
    out: Dict[str, ServeArtifact] = {}
    for cl in model.comp_layers:
        art = export_layer(model.get_weight(params, cl.name), comp[cl.name],
                           kind=cl.kind, layout="out_last", block_k=block_k)
        if art is not None:
            out[cl.name] = art
    return out


# ------------------------------------------------------------- serve forwards


def _rows(t: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    return None if t is None else t.reshape(-1, n).contiguous()


def serve_dense(x: torch.Tensor, art: ServeArtifact, *,
                bias: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None,
                activation: str = "none") -> torch.Tensor:
    """(..., K) -> act((..., K) @ W + bias) + residual, one fused LUT-GEMM
    launch. Flattens leading dims into a contiguous (M, K_x) matrix whose
    columns past K are zero."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    pad = art.k_x - art.k_dim
    x2d = F.pad(x2d, (0, pad)) if pad else x2d.contiguous()
    y = lut_matmul_fused(x2d, art.packed, art.codebook, art.scale, bias=bias,
                         residual=_rows(residual, art.n_dim),
                         activation=activation, pack_block=art.block_k)
    return y.reshape(*lead, art.n_dim)


def serve_conv(x: torch.Tensor, art: ServeArtifact, *, stride: int = 1,
               padding: str = "SAME", bias: Optional[torch.Tensor] = None,
               residual: Optional[torch.Tensor] = None,
               activation: str = "none") -> torch.Tensor:
    """NHWC conv through im2col feeding the fused LUT GEMM (bias/activation/
    residual ride the kernel epilogue). The patch matrix is built directly
    as contiguous (N*Ho*Wo, K_x) rows (the JAX package's ``cols.T``, zero
    past K)."""
    n, h, w_in, _ = x.shape
    kh = kw = art.kernel
    ho, wo = conv_out_hw(h, w_in, (kh, kw), stride, padding)
    rows = im2col_rows(x, (kh, kw), stride, padding, k_pad=art.k_x)
    y = lut_matmul_fused(rows, art.packed, art.codebook, art.scale, bias=bias,
                         residual=_rows(residual, art.n_dim),
                         activation=activation, pack_block=art.block_k)
    return y.reshape(n, ho, wo, art.n_dim)


def export_summary(arts: Dict[str, ServeArtifact]) -> Dict[str, float]:
    """Aggregate footprint of an exported model."""
    packed_bytes = sum(a.weight_bytes for a in arts.values())
    int8_bytes = sum(a.dense_bytes_int8 for a in arts.values())
    return {
        "layers": len(arts),
        "weight_bytes_packed": int(packed_bytes),
        "weight_bytes_dense_int8": int(int8_bytes),
        "compression_vs_int8": int8_bytes / max(packed_bytes, 1),
    }
