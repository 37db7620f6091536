"""Surface-normal (+kappa) network NNET.

Port of ``super_primitive_tpu/nets/nnet.py`` with the published scannet
parameter names (``encoder.original_model.*`` for the EfficientNet-B5,
``decoder.conv2``, ``decoder.up{1-4}._net.{0,1,3,4}``,
``decoder.out_conv_res8`` and the ``decoder.out_conv_res{4,2,1}.{0,2,4,6}``
Conv1d refine heads), NCHW.  The coarse-to-fine decoder emits (nx, ny, nz,
kappa) at 1/8 -> 1/4 -> 1/2 -> 1/1 of the decoder resolution (half the
input's); each level is refined by pointwise MLPs on upsampled features and
normalised with ELU-kappa.  Only the dense inference branch exists, as in
the JAX package.  Bilinear resizes are align_corners=True, as two
interpolation-matrix products; the decoder's BatchNorm eps is flax's 1e-5.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .efficientnet import BatchNorm2d, EfficientNetFeatures

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
