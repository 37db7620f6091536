"""EfficientNet-B5 (tf_efficientnet_b5_ap) feature backbone.

Port of ``super_primitive_tpu/nets/efficientnet.py`` with the published
geffnet parameter names (``conv_stem``, ``bn1``, ``blocks.{stage}.{block}.
conv_pw / conv_dw / se.conv_reduce / se.conv_expand / conv_pwl / bn1-3``,
``conv_head``), NCHW.  As the JAX package has it:
  - TensorFlow "SAME" padding, asymmetric (the extra pixel bottom/right),
    as an explicit pad before a VALID convolution;
  - BatchNorm eps 1e-3, inference only (running statistics);
  - silu activations, squeeze-excite on every block;
  - B5 scaling: width x1.6 (rounded to /8), depth x2.2 (ceil);
  - the head tap is the raw conv_head output, before bn2 (which feeds only
    the removed classifier and is not part of this model).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# base (B0) stage specs: (repeats, kernel, stride, expand, out_ch)
_B0_STAGES = [
    (1, 3, 1, 1, 16),
    (2, 3, 2, 6, 24),
    (2, 5, 2, 6, 40),
    (3, 3, 2, 6, 80),
    (3, 5, 1, 6, 112),
    (4, 5, 2, 6, 192),
    (1, 3, 1, 6, 320),
]


def round_channels(c: float, mult: float, divisor: int = 8) -> int:
    c *= mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def round_repeats(r: int, mult: float) -> int:
    return int(math.ceil(mult * r))


def tf_same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """TensorFlow SAME padding of (B, C, H, W): the extra pixel goes
    bottom/right."""

    def pad_amount(size):
        out = -(-size // stride)
        total = max(0, (out - 1) * stride + kernel - size)
        return total // 2, total - total // 2

    (top, bottom), (left, right) = pad_amount(x.shape[2]), pad_amount(x.shape[3])
    return F.pad(x, (left, right, top, bottom))


class BatchNorm2d(nn.Module):
    """Inference BatchNorm of (B, C, H, W) as flax computes it:
    (x - mean) * (rsqrt(var + eps) * weight) + bias."""

    def __init__(self, ch: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.eps = eps

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def _conv_same(x, conv: nn.Conv2d):
    k, s = conv.kernel_size[0], conv.stride[0]
    return conv(tf_same_pad(x, k, s))


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, reduced_ch: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(ch, reduced_ch, 1)
        self.conv_expand = nn.Conv2d(reduced_ch, ch, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class DepthwiseSeparable(nn.Module):
    """Stage-0 block (expand ratio 1): dw conv, SE, pw linear."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, se_ratio=0.25):
        super().__init__()
        self.conv_dw = nn.Conv2d(in_ch, in_ch, kernel, stride, groups=in_ch, bias=False)
        self.bn1 = BatchNorm2d(in_ch, 1e-3)
        self.se = SqueezeExcite(in_ch, max(1, int(in_ch * se_ratio)))
        self.conv_pw = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn2 = BatchNorm2d(out_ch, 1e-3)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        h = self.se(F.silu(self.bn1(_conv_same(x, self.conv_dw))))
        h = self.bn2(self.conv_pw(h))
        return h + x if self.residual else h


class MBConv(nn.Module):
    """Inverted residual: pw expand, dw conv, SE, pw linear."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, expand: int,
                 se_ratio=0.25):
        super().__init__()
        mid = in_ch * expand
        self.conv_pw = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = BatchNorm2d(mid, 1e-3)
        self.conv_dw = nn.Conv2d(mid, mid, kernel, stride, groups=mid, bias=False)
        self.bn2 = BatchNorm2d(mid, 1e-3)
        self.se = SqueezeExcite(mid, max(1, int(in_ch * se_ratio)))
        self.conv_pwl = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch, 1e-3)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_pw(x)))
        h = self.se(F.silu(self.bn2(_conv_same(h, self.conv_dw))))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


class EfficientNetFeatures(nn.Module):
    """Backbone emitting per-stage features: ``forward`` returns (the 7
    stage outputs, the 1/32-resolution conv_head output, pre-bn2)."""

    def __init__(self, width_mult: float = 1.6, depth_mult: float = 2.2, head_ch: int = 2048):
        super().__init__()
        stem_ch = round_channels(32, width_mult)
        self.conv_stem = nn.Conv2d(3, stem_ch, 3, 2, bias=False)
        self.bn1 = BatchNorm2d(stem_ch, 1e-3)
        blocks = []
        in_ch = stem_ch
        for r, k, s, e, c in _B0_STAGES:
            out_ch = round_channels(c, width_mult)
            stage = []
            for bi in range(round_repeats(r, depth_mult)):
                stride = s if bi == 0 else 1
                stage.append(DepthwiseSeparable(in_ch, out_ch, k, stride) if e == 1
                             else MBConv(in_ch, out_ch, k, stride, e))
                in_ch = out_ch
            blocks.append(nn.Sequential(*stage))
        self.blocks = nn.ModuleList(blocks)
        self.conv_head = nn.Conv2d(in_ch, head_ch, 1, bias=False)

    def forward(self, x):
        x = F.silu(self.bn1(_conv_same(x, self.conv_stem)))
        stage_outputs = []
        for stage in self.blocks:
            x = stage(x)
            stage_outputs.append(x)
        return stage_outputs, self.conv_head(x)
