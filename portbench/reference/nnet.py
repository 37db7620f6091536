"""Plain float32 reference of the NNET normal net (EfficientNet-B5 encoder,
coarse-to-fine decoder) and its ``predict_normals``.

Frozen copy of ``super_primitive_tpu_torch/nets/efficientnet.py`` and
``nets/nnet.py`` at commit 51882e36a88e (plain PyTorch modules, no kernel
of the port), so that a later change to the program cannot move the
yardstick.  It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
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
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _ac_interp_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) align_corners=True bilinear interpolation matrix."""
    ys = torch.linspace(0.0, n_in - 1.0, n_out, device=device)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, n_in - 1)
    y1 = torch.clamp(y0 + 1, 0, n_in - 1)
    wy = ys - y0
    A = torch.zeros(n_out, n_in, device=device)
    rows = torch.arange(n_out, device=device)
    A.index_put_((rows, y0), 1.0 - wy, accumulate=True)
    A.index_put_((rows, y1), wy, accumulate=True)
    return A


def resize_bilinear_ac(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize with align_corners=True of (B, C, H, W)."""
    Ho, Wo = out_hw
    Ay = _ac_interp_matrix(x.shape[2], Ho, x.device).to(x.dtype)
    Ax = _ac_interp_matrix(x.shape[3], Wo, x.device).to(x.dtype)
    t = torch.einsum("oh,bchw->bcow", Ay, x)
    return torch.einsum("pw,bcow->bcop", Ax, t)


def norm_normalize(out: torch.Tensor) -> torch.Tensor:
    """(nx, ny, nz, kappa) on channel axis 1: unit normal (norm + 1e-10),
    kappa = elu(k) + 1 + 0.01."""
    n, kappa = out[:, :3], out[:, 3:]
    norm = torch.sqrt(torch.sum(n * n, dim=1, keepdim=True)) + 1e-10
    return torch.cat([n / norm, F.elu(kappa) + 1.0 + 0.01], dim=1)


class UpSampleBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1), BatchNorm2d(cout, 1e-5), nn.LeakyReLU(0.01),
            nn.Conv2d(cout, cout, 3, padding=1), BatchNorm2d(cout, 1e-5), nn.LeakyReLU(0.01),
        )

    def forward(self, x, skip):
        up = resize_bilinear_ac(x, skip.shape[2:])
        return self._net(torch.cat([up, skip], dim=1))


class RefineMLP(nn.Sequential):
    """The pointwise refinement head: the published Conv1d (kernel 1) stack,
    applied to every pixel of a (B, C, H, W) map."""

    def __init__(self, cin: int):
        super().__init__(nn.Conv1d(cin, 128, 1), nn.ReLU(), nn.Conv1d(128, 128, 1), nn.ReLU(),
                         nn.Conv1d(128, 128, 1), nn.ReLU(), nn.Conv1d(128, 4, 1))

    def forward(self, h):
        h = h.permute(0, 2, 3, 1)
        for layer in self:
            h = F.linear(h, layer.weight[:, :, 0], layer.bias) if isinstance(layer, nn.Conv1d) \
                else layer(h)
        return h.permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.original_model = EfficientNetFeatures()

    def forward(self, x):
        return self.original_model(x)


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv2 = nn.Conv2d(2048, 2048, 1)
        self.up1 = UpSampleBN(2048 + 176, 1024)
        self.up2 = UpSampleBN(1024 + 64, 512)
        self.up3 = UpSampleBN(512 + 40, 256)
        self.up4 = UpSampleBN(256 + 24, 128)
        self.out_conv_res8 = nn.Conv2d(512, 4, 3, padding=1)
        self.out_conv_res4 = RefineMLP(512 + 4)
        self.out_conv_res2 = RefineMLP(256 + 4)
        self.out_conv_res1 = RefineMLP(128 + 4)

    def forward(self, b0, b1, b2, b3, b4):
        x_d0 = self.conv2(b4)
        x_d1 = self.up1(x_d0, b3)
        x_d2 = self.up2(x_d1, b2)
        x_d3 = self.up3(x_d2, b1)
        x_d4 = self.up4(x_d3, b0)
        out8 = norm_normalize(self.out_conv_res8(x_d2))

        def up2x(t):
            return resize_bilinear_ac(t, (2 * t.shape[2], 2 * t.shape[3]))

        out4 = norm_normalize(self.out_conv_res4(torch.cat([up2x(x_d2), up2x(out8)], dim=1)))
        out2 = norm_normalize(self.out_conv_res2(torch.cat([up2x(x_d3), up2x(out4)], dim=1)))
        return norm_normalize(self.out_conv_res1(torch.cat([up2x(x_d4), up2x(out2)], dim=1)))


class NNET(nn.Module):
    """Input (B, 3, H, W) ImageNet-normalised RGB; output (B, 4, H/2, W/2) =
    (unit normal, kappa), the reference's out_res1."""

    def __init__(self):
        super().__init__()
        self.encoder = Encoder()
        self.decoder = Decoder()

    def forward(self, x, taps=None):
        """``taps``: the five encoder features (stage 0, 1, 2, 4 outputs and
        the conv_head output) in place of running the encoder."""
        if taps is None:
            stages, head = self.encoder(x)
            taps = (stages[0], stages[1], stages[2], stages[4], head)
        return self.decoder(*taps)


def preprocess(image_chw01: torch.Tensor, network_dim) -> torch.Tensor:
    """(3, H, W) in [0, 1] -> (1, 3, h, w) ImageNet-normalised at the
    network input size."""
    img = resize_bilinear_ac(image_chw01[None], tuple(network_dim))
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=img.device)[:, None, None]
    return (img - mean) / std


@torch.no_grad()
def predict_normals(model: NNET, image, network_dim=(480, 640), coarse_hw=None):
    """Run ``model`` on an (H, W, 3) image, uint8 or float in [0, 1]
    (numpy or tensor), on the model's device.  Returns (normals (H, W, 3),
    kappa (H, W, 1)) float32 tensors at the image's resolution, or at
    ``coarse_hw`` by a nearest subsample on the device (source index
    arange(Hc) * H // Hc).

    A uint8 image uploads as bytes and divides by 255 in float32 on the
    device.  The net runs in float32."""
    dev = next(model.parameters()).device
    img = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image) else image)
    img = img.to(dev, non_blocking=True)
    img = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()
    H, W = img.shape[:2]
    x = preprocess(img.permute(2, 0, 1), network_dim)
    out = resize_bilinear_ac(model(x), (H, W))[0]
    if coarse_hw is not None:
        Hc, Wc = coarse_hw
        ri = torch.arange(Hc, device=dev) * H // Hc
        ci = torch.arange(Wc, device=dev) * W // Wc
        out = out[:, ri[:, None], ci[None, :]]
    out = out.permute(1, 2, 0)
    return out[..., :3], out[..., 3:]
