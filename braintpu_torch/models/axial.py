"""Axial attention for 3D volumes (the KAIST Axial_UNet ingredient).

Counterpart of ``braintpu/models/axial.py``: factorized self-attention along
each spatial axis in turn (the other two axes folded into the batch), with
additive per-axis positional embeddings.  The decoder variant of
``Generic_UNet`` applies it sequentially and residually after an up-conv;
the Axial_UNet family wraps it in a block (positional embedding, summed
per-axis attention, BatchNorm, LeakyReLU).

The parameters are the reference's nested dicts: ``{"pos": {"d", "h",
"w"}: (axis length, C), "axes": [3 x {"qkv": (C, 3 inner), "out": (inner,
C)[, "out_b": (C,)]}]}``, with a block's BatchNorm under ``"bn"``.  The
head count is not stored: it is ``inner // dim_head`` at apply time, as in
the reference.

The attention is plain PyTorch (``torch.matmul`` and ``softmax``, no
hand-written kernel: the reference computes it with XLA einsums and no
Pallas kernel either), at the reference's precision: the projections at
the activation dtype, the logits and the softmax in f32 (the bf16 ``q`` and
``k`` upcast, so the products are exact and the sums f32, as XLA's
``preferred_element_type=f32``), the weights cast back to the activation
dtype before ``P @ V``.  ``scaled_dot_product_attention`` is not used: its
bf16 path rounds elsewhere.  The folded batch is chunked under a byte budget
for one chunk's f32 logits, as the reference chunks it through ``lax.map``;
the per-row arithmetic does not change with the chunk.

Random initialisation draws from a numpy Generator; the reference draws the
attention leaves from its own random keys, so the values differ (a known delta:
the port's ``init_params`` keeps its conv leaves bit-equal to the
reference's and draws the attention from a generator of its own).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "init_axial_params",
    "apply_axial_attention",
    "init_axial_block",
    "apply_axial_block",
    "axial_stage_shapes",
]

#: Device-memory budget for one chunk's f32 attention logits.  Folding two
#: spatial axes into the batch makes the folded batch large at the fine
#: decoder stages (8 mirror copies of a 128^3 stage: 131,072 rows of 128, up
#: to 17 GB of logits per axis at once); chunking bounds that temporary.
#: The value is the card's, measured by ``python -m braintpu_torch.tools.probe
#: attn`` on an H100 (PERF.md "Axial families"): at 1 GiB every stage ran
#: within 1 % of its fastest budget (8 GiB), at a quarter of its peak memory.
_MAX_LOGIT_BYTES = 1024 * 1024 * 1024


def _he(rng: np.random.Generator, shape, draw_dtype: torch.dtype) -> torch.Tensor:
    """He-normal f32 leaf: a standard normal draw at ``draw_dtype`` times
    sqrt(2 / fan_in) in f32 (the reference scales by an f64 numpy scalar,
    which promotes a bf16 draw to an f32 leaf)."""
    fan_in = shape[0]
    vals = rng.standard_normal(shape, dtype=np.float32)
    if draw_dtype != torch.float32:
        vals = torch.from_numpy(vals).to(draw_dtype).float().numpy()
    return torch.from_numpy(vals * np.float32(np.sqrt(2.0 / fan_in)))


def init_axial_params(
    rng: np.random.Generator,
    channels: int,
    shape_dhw: Tuple[int, int, int],
    heads: int,
    dim_head: int,
    param_dtype: torch.dtype = torch.float32,
) -> Dict[str, Any]:
    """One axial attention's parameters: per spatial axis a fused QKV
    projection and an output projection (He-normal, drawn from ``rng`` at
    ``param_dtype`` and scaled into f32 leaves, as the reference's), and zero
    positional embeddings per axis at ``param_dtype``."""
    inner = heads * dim_head
    d, h, w = shape_dhw
    axes = []
    for _ in range(3):
        qkv = _he(rng, (channels, 3 * inner), param_dtype)
        axes.append({"qkv": qkv, "out": _he(rng, (inner, channels), param_dtype)})
    return {
        "pos": {"d": torch.zeros(d, channels, dtype=param_dtype),
                "h": torch.zeros(h, channels, dtype=param_dtype),
                "w": torch.zeros(w, channels, dtype=param_dtype)},
        "axes": axes,
    }


def _chunk_rows(B: int, row_bytes: int) -> int:
    """Rows per chunk: all of them within the budget, else the largest power
    of two dividing ``B`` whose logits fit (the reference's rule)."""
    if B * row_bytes <= _MAX_LOGIT_BYTES:
        return B
    chunk = 1
    while B % (chunk * 2) == 0 and (chunk * 2) * row_bytes <= _MAX_LOGIT_BYTES:
        chunk *= 2
    return chunk


def _axis_attention(x: torch.Tensor, wqkv, wout, heads: int, dim_head: int,
                    bout=None) -> torch.Tensor:
    """Self-attention along the middle axis of a (B, L, C) tensor."""
    B, L, C = x.shape
    inner = heads * dim_head
    dt = x.dtype
    wqkv, wout = wqkv.to(dt), wout.to(dt)
    bout = None if bout is None else bout.to(dt)

    def attend(xc: torch.Tensor) -> torch.Tensor:
        n = xc.shape[0]
        q, k, v = (t.reshape(n, L, heads, dim_head).transpose(1, 2)
                   for t in torch.matmul(xc, wqkv).split(inner, dim=-1))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dim_head ** -0.5)
        weights = torch.softmax(logits, dim=-1).to(dt)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(n, L, inner)
        y = torch.matmul(out, wout)
        # the reference package's to_out Linear carries a bias; present only
        # on converted checkpoints
        return y if bout is None else y + bout

    chunk = _chunk_rows(B, heads * L * L * 4)
    if chunk == B:
        return attend(x)
    return torch.cat([attend(x[i:i + chunk]) for i in range(0, B, chunk)])


def _one_axis(params_axis, x: torch.Tensor, axis: int, heads: int, dim_head: int):
    """Attention along spatial ``axis`` (0=D, 1=H, 2=W) of (N, D, H, W, C)."""
    N, D, H, W, C = x.shape
    args = (params_axis["qkv"], params_axis["out"], heads, dim_head, params_axis.get("out_b"))
    if axis == 0:
        y = _axis_attention(x.permute(0, 2, 3, 1, 4).reshape(N * H * W, D, C), *args)
        return y.reshape(N, H, W, D, C).permute(0, 3, 1, 2, 4)
    if axis == 1:
        y = _axis_attention(x.permute(0, 1, 3, 2, 4).reshape(N * D * W, H, C), *args)
        return y.reshape(N, D, W, H, C).permute(0, 1, 3, 2, 4)
    y = _axis_attention(x.reshape(N * D * H, W, C), *args)
    return y.reshape(N, D, H, W, C)


def apply_axial_attention(params: Dict[str, Any], x: torch.Tensor, dim_head: int = 32,
                          sum_axial_out: bool = False) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, D, H, W, C): positional embedding, then
    per-axis attention, sequential (each axis on the previous axis's output:
    the decoder variant) or summed (all three on the same input: the
    Axial_UNet block)."""
    inner = params["axes"][0]["qkv"].shape[1] // 3
    heads = max(1, inner // dim_head)
    pos = params["pos"]
    x = (x + pos["d"].to(x.dtype)[None, :, None, None, :]
         + pos["h"].to(x.dtype)[None, None, :, None, :]
         + pos["w"].to(x.dtype)[None, None, None, :, :])
    if sum_axial_out:
        return sum(_one_axis(params["axes"][i], x, i, heads, dim_head) for i in range(3))
    for i in range(3):
        x = _one_axis(params["axes"][i], x, i, heads, dim_head)
    return x


def init_axial_block(rng: np.random.Generator, channels: int, shape_dhw: Tuple[int, int, int],
                     heads: int, dim_head: int, bn: bool = True,
                     param_dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """AxialAttention3D block parameters: the attention
    (:func:`init_axial_params`) and, with ``bn``, a BatchNorm at
    ``param_dtype`` (scale 1, shift 0, running mean 0, running variance 1)."""
    out: Dict[str, Any] = {"attn": init_axial_params(rng, channels, shape_dhw, heads, dim_head,
                                                     param_dtype)}
    if bn:
        out["bn"] = {"scale": torch.ones(channels, dtype=param_dtype),
                     "shift": torch.zeros(channels, dtype=param_dtype),
                     "mean": torch.zeros(channels, dtype=param_dtype),
                     "var": torch.ones(channels, dtype=param_dtype)}
    return out


def apply_axial_block(
    params: Dict[str, Any],
    x: torch.Tensor,
    dim_head: int,
    negative_slope: float = 0.01,
    sum_axial_out: bool = True,
    residual: bool = False,
    eps: float = 1e-5,
    train: bool = False,
    bn_momentum: float = 0.1,
):
    """AxialAttention3D block: attention -> BatchNorm -> LeakyReLU (in f32,
    rounded to the activation dtype), optionally residual.

    ``train=False`` normalizes with the running statistics and returns
    ``y``.  ``train=True`` normalizes with the batch statistics (biased
    variance) and returns ``(y, new_bn or None)``, ``new_bn`` holding the
    running mean and variance updated with the unbiased variance (torch
    ``BatchNorm3d`` semantics, as the conv blocks' BatchNorm).
    """
    y = apply_axial_attention(params["attn"], x, dim_head, sum_axial_out)
    new_bn: Optional[Dict[str, torch.Tensor]] = None
    if "bn" in params:
        bn = params["bn"]
        yf = y.float()
        scale, shift = bn["scale"].float(), bn["shift"].float()
        if train:
            mean = bn["mean"].detach().float().clone()
            var = bn["var"].detach().float().clone()
            yf = F.batch_norm(yf.permute(0, 4, 1, 2, 3), mean, var, scale, shift, True,
                              bn_momentum, eps).permute(0, 2, 3, 4, 1)
            new_bn = {"mean": mean, "var": var}
        else:
            yf = (yf - bn["mean"].float()) * torch.rsqrt(bn["var"].float() + eps) * scale + shift
        y = torch.where(yf >= 0, yf, yf * negative_slope).to(y.dtype)
    if residual:
        y = (x + y).to(y.dtype)
    return (y, new_bn) if train else y


def axial_stage_shapes(patch_size: Tuple[int, int, int], num_pool: int,
                       no_attention: Sequence[int]) -> Dict[int, Tuple[int, int, int]]:
    """Decoder stage index -> the feature-map shape where attention applies:
    stage ``u`` works at ``patch / 2**(num_pool - u - 1)``."""
    out = {}
    for u in range(num_pool):
        if u in no_attention:
            continue
        d = num_pool - u - 1
        out[u] = tuple(int(s // (2**d)) for s in patch_size)
    return out
