"""Plain SegFormer (Xie et al., arXiv:2105.15203), the reference of the
`segformer_*` configurations, written in the paper's equations: every
dense product a linear layer or a matrix product through `num`.

- Overlapping patch embeddings (a 7x7 stride-4 convolution, then 3x3
  stride-2 ones, padding k // 2; `num.conv`), each followed by a LayerNorm
  at eps 1e-5.
- Blocks `x + Attn(LN(x))`, `x + MixFFN(LN(x))`, LayerNorms at eps 1e-6,
  and a LayerNorm at eps 1e-6 after each stage.
- Efficient self-attention, Eq. 2: the token map cropped to multiples of
  R (as the strided RxR convolution leaves the rest out), cut into RxR
  patches, each patch's C * R^2 values to C by a linear layer (the
  convolution's weight reshaped), a LayerNorm at eps 1e-5; q and kv linear
  layers; softmax(q k^T / sqrt(d)) v as two `num.matmul`s; `proj`.
- Mix-FFN, Eq. 3: fc1, a depthwise 3x3 convolution with bias
  (`num.conv`), exact GELU, fc2.
- The all-MLP decoder, Eq. 4: a linear layer a stage to `decoder_dim`,
  `F.interpolate` (bilinear, corners not aligned) to 1/4, concatenation
  c4, c3, c2, c1, `linear_fuse` as a bias-free linear layer over the
  tokens, BatchNorm and ReLU, `linear_pred` as a linear layer over the
  tokens in f32, and `F.interpolate` to the input's size.

The module names are the port's (the published checkpoint's), so one state
dict loads into both.  Drop-path and head dropout must be 0: the
comparison follows the program's steps and cannot draw its masks.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100_bench.reference.layers import PLAIN, BatchNorm
from h100_bench.weights import fixed

PATCH_EPS = 1e-5
BLOCK_EPS = 1e-6


def _ln(x, mod: nn.LayerNorm):
    return F.layer_norm(x, mod.normalized_shape, mod.weight, mod.bias,
                        mod.eps)


def _lin(num, x, mod: nn.Linear):
    return num.linear(x, mod.weight, mod.bias)


def _tokens(x):
    """[B, C, H, W] -> [B, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


def _map(t, h, w):
    """[B, H*W, C] -> [B, C, H, W]."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


def _up(x, hw):
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, nin, nout, patch, stride, num):
        super().__init__()
        self.proj = nn.Conv2d(nin, nout, patch, stride, patch // 2)
        self.norm = nn.LayerNorm(nout, eps=PATCH_EPS)
        self.num = num

    def forward(self, x):
        p = self.proj
        y = self.num.conv(x, p.weight, p.bias, p.stride, p.padding)
        return _ln(_tokens(y), self.norm), y.shape[2], y.shape[3]


class Attention(nn.Module):
    def __init__(self, dim, heads, sr_ratio, num):
        super().__init__()
        self.heads, self.sr_ratio, self.num = heads, sr_ratio, num
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=PATCH_EPS)

    def reduce(self, x, h, w):
        """Eq. 2: RxR patches of the token map, each to C values."""
        r, num = self.sr_ratio, self.num
        b, _, c = x.shape
        hr, wr = h // r, w // r
        m = _map(x, h, w)[:, :, :hr * r, :wr * r]
        patches = m.reshape(b, c, hr, r, wr, r).permute(0, 2, 4, 1, 3, 5)
        patches = patches.reshape(b, hr * wr, c * r * r)
        y = num.linear(patches, self.sr.weight.reshape(c, c * r * r),
                       self.sr.bias)
        return _ln(y, self.norm)

    def forward(self, x, h, w):
        num = self.num
        b, n, c = x.shape
        d = c // self.heads
        q = _lin(num, x, self.q).reshape(b, n, self.heads, d).transpose(1, 2)
        r = self.reduce(x, h, w) if self.sr_ratio > 1 else x
        kv = _lin(num, r, self.kv).reshape(b, -1, 2, self.heads, d)
        k, v = kv.permute(2, 0, 3, 1, 4)
        att = torch.softmax(num.matmul(q, k.transpose(-2, -1))
                            * d ** -0.5, dim=-1)
        o = num.matmul(att, v).transpose(1, 2).reshape(b, n, c)
        return _lin(num, o, self.proj)


class DWConv(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)


class MixFFN(nn.Module):
    def __init__(self, dim, hidden, num):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.num = num

    def forward(self, x, h, w):
        num = self.num
        y = _lin(num, x, self.fc1)
        dw = self.dwconv.dwconv
        y = num.conv(_map(y, h, w), dw.weight, dw.bias, padding=1,
                     groups=y.shape[2])
        return _lin(num, F.gelu(_tokens(y)), self.fc2)


class Block(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, sr_ratio, num):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=BLOCK_EPS)
        self.attn = Attention(dim, heads, sr_ratio, num)
        self.norm2 = nn.LayerNorm(dim, eps=BLOCK_EPS)
        self.mlp = MixFFN(dim, dim * mlp_ratio, num)

    def forward(self, x, h, w):
        x = x + self.attn(_ln(x, self.norm1), h, w)
        return x + self.mlp(_ln(x, self.norm2), h, w)


class MixVisionTransformer(nn.Module):
    def __init__(self, embed_dims, num_heads, depths, sr_ratios, mlp_ratio,
                 num):
        super().__init__()
        nin = 3
        for i, (dim, heads, depth, sr) in enumerate(
                zip(embed_dims, num_heads, depths, sr_ratios), start=1):
            patch, stride = (7, 4) if i == 1 else (3, 2)
            setattr(self, f"patch_embed{i}",
                    OverlapPatchEmbed(nin, dim, patch, stride, num))
            setattr(self, f"block{i}", nn.ModuleList(
                Block(dim, heads, mlp_ratio, sr, num) for _ in range(depth)))
            setattr(self, f"norm{i}", nn.LayerNorm(dim, eps=BLOCK_EPS))
            nin = dim
        self.stages = len(embed_dims)

    def forward(self, x):
        outs = []
        for i in range(1, self.stages + 1):
            x, h, w = getattr(self, f"patch_embed{i}")(x)
            for blk in getattr(self, f"block{i}"):
                x = blk(x, h, w)
            x = _map(_ln(x, getattr(self, f"norm{i}")), h, w)
            outs.append(x)
        return outs


class MLP(nn.Module):
    def __init__(self, nin, nout):
        super().__init__()
        self.proj = nn.Linear(nin, nout)


class ConvModule(nn.Module):
    def __init__(self, nin, nout):
        super().__init__()
        self.conv = nn.Conv2d(nin, nout, 1, bias=False)
        self.bn = BatchNorm(nout)


class SegFormerHead(nn.Module):
    def __init__(self, in_dims, dim, num_classes, num):
        super().__init__()
        for i, c in enumerate(in_dims, start=1):
            setattr(self, f"linear_c{i}", MLP(c, dim))
        self.stages = len(in_dims)
        self.linear_fuse = ConvModule(dim * len(in_dims), dim)
        self.linear_pred = nn.Conv2d(dim, num_classes, 1)
        self.num = num

    def forward(self, feats):
        num = self.num
        b, _, h, w = feats[0].shape
        ups = []
        for i in range(self.stages, 0, -1):
            f = feats[i - 1]
            y = _lin(num, _tokens(f), getattr(self, f"linear_c{i}").proj)
            ups.append(_up(_map(y, f.shape[2], f.shape[3]), (h, w)))
        cat = _tokens(torch.cat(ups, dim=1))
        fuse = self.linear_fuse
        y = num.linear(cat, fuse.conv.weight.flatten(1))
        y = F.relu(fuse.bn(_map(y, h, w)))
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        p = self.linear_pred
        y = num.linear(_tokens(y), p.weight.flatten(1), p.bias)
        return _map(y, h, w)


class SegFormer(nn.Module):
    """f32 channel-major logits [B, num_classes, H, W] of NCHW input."""

    def __init__(self, num_classes, embed_dims=(64, 128, 320, 512),
                 num_heads=(1, 2, 5, 8), depths=(3, 6, 40, 3),
                 sr_ratios=(8, 4, 2, 1), mlp_ratio=4, decoder_dim=768,
                 drop_path_rate=0.0, head_dropout=0.0,
                 compute_dtype=torch.float32, num=PLAIN):
        super().__init__()
        if drop_path_rate or head_dropout:
            raise ValueError("the reference takes drop_path_rate and "
                             "head_dropout at 0 only")
        self.compute_dtype = compute_dtype
        self.backbone = MixVisionTransformer(embed_dims, num_heads, depths,
                                             sr_ratios, mlp_ratio, num)
        self.decode_head = SegFormerHead(embed_dims, decoder_dim,
                                         num_classes, num)

    def forward(self, x):
        y = self.decode_head(self.backbone(x.to(self.compute_dtype)))
        return _up(y, x.shape[2:])


MODEL = SegFormer
# the FLOP counter's ops that the whole step's share counts: the linear
# layers' and attention's products.  Left out: the four overlapping patch
# embeddings and the Mix-FFN's depthwise convolutions, 1.8 of 97.8 GFLOP
# an image at 256x480, so the share reads ~1.9% low and never high.
# torch's flop counter counts a grouped convolution's weight gradient as
# a dense one (`conv_backward_flop` ignores `groups`): with "convolution"
# a B5 train step would count 3.4x its products.
DENSE_OPS = ("mm",)


def weight_law(name: str, shape):
    """The published laws: linear layers from a normal at std 0.02 (the
    truncated normal cuts at +-2 in absolute value, 100 std), convolutions
    from a normal at sqrt(2 / fan_out) with fan_out = k^2 * out / groups,
    the head's linear layers and `linear_pred` (PyTorch's default uniform
    law) from a normal at its variance 1 / (3 fan_in), biases 0, LayerNorm
    and BatchNorm scales 1."""
    law = fixed(name)
    if law is not None:
        return law
    if name.startswith(("decode_head.linear_c", "decode_head.linear_pred")):
        return "normal", math.sqrt(1.0 / (3 * math.prod(shape[1:])))
    if len(shape) == 4:
        groups = shape[0] if ".dwconv." in name else 1
        fan_out = shape[0] * shape[2] * shape[3] // groups
        return "normal", math.sqrt(2.0 / fan_out)
    if len(shape) == 2:
        return "normal", 0.02
    return "const", 1.0  # LayerNorm and BatchNorm scales
