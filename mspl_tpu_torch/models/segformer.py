"""SegFormer segmentation model (Xie et al., arXiv:2105.15203), NCHW in,
channel-major logits out.

The Mix Transformer encoder and the all-MLP decoder of the published code
(NVlabs/SegFormer `mmseg/models/backbones/mix_transformer.py` and
`mmseg/models/decode_heads/segformer_head.py`), at B5's widths and depths
by default:

- four stages, each an overlapping patch embedding (a 7x7 stride-4
  convolution, then 3x3 stride-2 ones, padding k // 2, each followed by a
  LayerNorm at eps 1e-5), blocks `x + Attn(LN(x))`, `x + MixFFN(LN(x))`
  (block LayerNorms at eps 1e-6) and a LayerNorm at eps 1e-6;
- spatial-reduction attention: q = Linear(C, C) of the tokens; keys and
  values from a stride-R RxR convolution of the token map, a LayerNorm
  (eps 1e-5) and kv = Linear(C, 2C); softmax at scale head_dim^-0.5, then
  `proj`;
- Mix-FFN: fc1 (C -> 4C), a depthwise 3x3 convolution with bias on the
  token map, exact GELU, fc2;
- the head: a Linear(C_i, decoder_dim) per stage, bilinear upsampling to
  1/4 (`ops/resize.py`, corners not aligned), concatenation c4, c3, c2, c1,
  `linear_fuse` (a bias-free 1x1 convolution, the port's BatchNorm, ReLU),
  channel dropout, `linear_pred` (in f32) and a bilinear resize to the
  input's size.

Module names are the published checkpoint's (`backbone.patch_embed1.proj`,
`backbone.block3.12.attn.kv`, `decode_head.linear_fuse.bn`, ...), so a
mmseg SegFormer state dict loads with `load_state_dict`.  Parameters stay
f32; `compute_dtype` is the activations' dtype, the weights cast to it
where they are used; the classifier and the final resize run in f32.

`drop_path_rate` (stochastic depth, rising linearly from 0 over the blocks
as published) and `head_dropout` (`Dropout2d` before `linear_pred`) act in
train mode only: a per-sample mask on each residual branch, a per-sample,
per-channel mask on the head.

Attention's two products run through `F.scaled_dot_product_attention`.
In f32 on the H100 torch picks its memory-efficient kernel, whose products
round ~5e-7 of the output's norm away from f64, against ~4e-4 for products
whose operands round to TF32 (`tests_card/test_torch_segformer_card.py`;
`_sdpa_backend` names the kernel torch picks for given operands).

Under a profiler the forward opens the spans `mspl.segformer.embed:<i>`,
`mspl.segformer.attn:<i>`, `mspl.segformer.ffn:<i>` (stage i = 1 to 4)
and `mspl.segformer.head` (`utils/profiling.py`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mspl_tpu_torch.layers.conv_blocks import BatchNorm
from mspl_tpu_torch.ops.resize import resize_bilinear
from mspl_tpu_torch.utils.profiling import span

PATCH_EPS = 1e-5   # the patch embeddings' and the reduction's LayerNorms
BLOCK_EPS = 1e-6   # the blocks' and the stage ends' LayerNorms


class Linear(nn.Linear):
    """A linear layer over the last axis, in the activation's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, in the activation's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class Conv(nn.Conv2d):
    """A convolution in the activation's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


def _map(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H*W, C] -> [B, C, H, W] (a view)."""
    return t.transpose(1, 2).unflatten(2, (h, w))


def drop_path(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    """Stochastic depth: each sample's branch kept with probability 1 - p
    and scaled by 1 / (1 - p) in train mode; the identity otherwise."""
    if p == 0.0 or not training:
        return x
    keep = 1.0 - p
    mask = x.new_empty((x.shape[0],) + (1,) * (x.dim() - 1)).bernoulli_(keep)
    return x * mask / keep


def _sdpa_backend(q, k, v, scale) -> str:
    """`sdpa:<backend>`, the kernel `F.scaled_dot_product_attention` picks
    for these operands."""
    choice = torch._fused_sdp_choice(q, k, v, None, 0.0, False, scale=scale)
    return "sdpa:" + torch.nn.attention.SDPBackend(choice).name.lower()


class OverlapPatchEmbed(nn.Module):
    """A k x k stride-s convolution with padding k // 2, then a LayerNorm
    of its tokens."""

    def __init__(self, nin: int, nout: int, patch: int, stride: int):
        super().__init__()
        self.proj = Conv(nin, nout, patch, stride, padding=patch // 2)
        self.norm = LayerNorm(nout, eps=PATCH_EPS)

    def forward(self, x: torch.Tensor):
        y = self.proj(x)
        return self.norm(_tokens(y)), y.shape[2], y.shape[3]


class Attention(nn.Module):
    """Spatial-reduction multi-head attention of a stage's tokens."""

    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.scale = (dim // heads) ** -0.5
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, sr_ratio)
            self.norm = LayerNorm(dim, eps=PATCH_EPS)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        q = self.q(x).view(b, n, self.heads, d).transpose(1, 2)
        r = x
        if self.sr_ratio > 1:
            r = self.norm(_tokens(self.sr(_map(x, h, w))))
        k, v = self.kv(r).view(b, -1, 2, self.heads, d).permute(
            2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, scale=self.scale)
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class DWConv(nn.Module):
    """A depthwise 3x3 convolution with bias on the token map."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return _tokens(self.dwconv(_map(x, h, w)))


class MixFFN(nn.Module):
    """fc1, the depthwise convolution, exact GELU, fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), h, w)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, sr_ratio: int,
                 drop_path: float, stage: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=BLOCK_EPS)
        self.attn = Attention(dim, heads, sr_ratio)
        self.norm2 = LayerNorm(dim, eps=BLOCK_EPS)
        self.mlp = MixFFN(dim, dim * mlp_ratio)
        self.drop_path = drop_path
        self.spans = (f"mspl.segformer.attn:{stage}",
                      f"mspl.segformer.ffn:{stage}")

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        with span(self.spans[0]):
            x = x + drop_path(self.attn(self.norm1(x), h, w),
                              self.drop_path, self.training)
        with span(self.spans[1]):
            return x + drop_path(self.mlp(self.norm2(x), h, w),
                                 self.drop_path, self.training)


class MixVisionTransformer(nn.Module):
    """The encoder: four stages, each returned as a [B, C_i, H_i, W_i]
    map."""

    def __init__(self, in_channels, embed_dims, num_heads, depths,
                 sr_ratios, mlp_ratio, drop_path_rate):
        super().__init__()
        n = sum(depths)
        rates = [drop_path_rate * j / max(n - 1, 1) for j in range(n)]
        nin, at = in_channels, 0
        for i, (dim, heads, depth, sr) in enumerate(
                zip(embed_dims, num_heads, depths, sr_ratios), start=1):
            patch, stride = (7, 4) if i == 1 else (3, 2)
            setattr(self, f"patch_embed{i}",
                    OverlapPatchEmbed(nin, dim, patch, stride))
            setattr(self, f"block{i}", nn.ModuleList(
                Block(dim, heads, mlp_ratio, sr, rates[at + j], i)
                for j in range(depth)))
            setattr(self, f"norm{i}", LayerNorm(dim, eps=BLOCK_EPS))
            nin, at = dim, at + depth
        self.stages = len(embed_dims)

    def forward(self, x: torch.Tensor):
        outs = []
        for i in range(1, self.stages + 1):
            with span(f"mspl.segformer.embed:{i}"):
                x, h, w = getattr(self, f"patch_embed{i}")(x)
            for blk in getattr(self, f"block{i}"):
                x = blk(x, h, w)
            x = _map(getattr(self, f"norm{i}")(x), h, w).contiguous()
            outs.append(x)
        return outs


class MLP(nn.Module):
    """A stage's tokens to the decoder's width."""

    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.proj = Linear(nin, nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        return _map(self.proj(_tokens(x)), h, w)


class ConvModule(nn.Module):
    """A bias-free 1x1 convolution, BatchNorm and ReLU."""

    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv = Conv(nin, nout, 1, bias=False)
        self.bn = BatchNorm(nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class SegFormerHead(nn.Module):
    """The all-MLP decoder: each stage to `dim` channels at 1/4, fused."""

    def __init__(self, in_dims: Sequence[int], dim: int, num_classes: int,
                 dropout: float):
        super().__init__()
        for i, c in enumerate(in_dims, start=1):
            setattr(self, f"linear_c{i}", MLP(c, dim))
        self.stages = len(in_dims)
        self.linear_fuse = ConvModule(dim * len(in_dims), dim)
        self.dropout = dropout
        self.linear_pred = nn.Conv2d(dim, num_classes, 1)

    def forward(self, feats):
        hw = feats[0].shape[2:]
        ups = []
        for i in range(self.stages, 0, -1):  # c4, c3, c2, c1
            y = getattr(self, f"linear_c{i}")(feats[i - 1])
            if i > 1:
                y = resize_bilinear(y, hw, align_corners=False)
            ups.append(y)
        y = self.linear_fuse(torch.cat(ups, dim=1))
        y = F.dropout2d(y, self.dropout, self.training)
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        return self.linear_pred(y)


class SegFormer(nn.Module):
    """SegFormer: NCHW input, f32 channel-major logits [B, num_classes, H,
    W] at the input's size (module docstring).  `in_channels` is the
    image's channel count (4 for RGB-D)."""

    def __init__(self, num_classes: int,
                 compute_dtype: torch.dtype = torch.float32,
                 embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 depths: Sequence[int] = (3, 6, 40, 3),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 mlp_ratio: int = 4, decoder_dim: int = 768,
                 drop_path_rate: float = 0.0, head_dropout: float = 0.0,
                 in_channels: int = 3):
        super().__init__()
        if not (len(embed_dims) == len(num_heads) == len(depths)
                == len(sr_ratios)):
            raise ValueError("embed_dims, num_heads, depths and sr_ratios "
                             "need one entry a stage")
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.backbone = MixVisionTransformer(
            in_channels, embed_dims, num_heads, depths, sr_ratios, mlp_ratio,
            drop_path_rate)
        self.decode_head = SegFormerHead(embed_dims, decoder_dim,
                                         num_classes, head_dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x.to(self.compute_dtype))
        with span("mspl.segformer.head"):
            y = self.decode_head(feats)
            return resize_bilinear(y, (x.shape[2], x.shape[3]),
                                   align_corners=False)
