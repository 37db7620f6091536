"""The benchmark's inputs: synthetic weights of SAM and the NNET at a
trained net's scale, drawn from the configuration's seed, and views of a
piecewise-planar scene (an entry draws their order, and what else a frame
needs, from ``--seed``).

Frozen copies, at commit 51882e36a88e, of
``super_primitive_tpu_torch/nets/synth.py`` (the state dicts' keys and
shapes, in the published segment-anything and scannet names, and
``scale_like_trained``'s scales) and of
``super_primitive_tpu_torch/data/synthetic.py`` (``PlanesScene`` and the
"orbit" path of ``PlanesSequence``).  Two things differ from those
sources, and neither changes what the program is given to do: the values
are drawn on the device by one ``torch.Generator`` call a net, not leaf by
leaf by numpy, and the frames are rendered on the device in float64.

The program never sees the seed: it receives the state dicts, the frames,
the intrinsics and, for depth completion, the sparse depth.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ----------------------------------------------------------------- weights
def sam_shapes(sam: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every SAM parameter, in ``synth_sam_state_dict``'s
    order, for the ViT configuration ``sam`` (the config file's "sam")."""
    D, HN, P = sam["embed_dim"], sam["num_heads"], sam["patch_size"]
    S = sam["img_size"] // P
    C = sam["out_chans"]
    hd = D // HN
    hidden = int(D * sam["mlp_ratio"])
    out = []

    def w(name, *shape):
        out.append((name, shape))

    w("image_encoder.patch_embed.proj.weight", D, 3, P, P)
    w("image_encoder.patch_embed.proj.bias", D)
    w("image_encoder.pos_embed", 1, S, S, D)
    for i in range(sam["depth"]):
        p = f"image_encoder.blocks.{i}"
        for n in ("norm1", "norm2"):
            w(f"{p}.{n}.weight", D)
            w(f"{p}.{n}.bias", D)
        w(f"{p}.attn.qkv.weight", 3 * D, D)
        w(f"{p}.attn.qkv.bias", 3 * D)
        w(f"{p}.attn.proj.weight", D, D)
        w(f"{p}.attn.proj.bias", D)
        size = S if i in sam["global_attn_indexes"] else sam["window_size"]
        w(f"{p}.attn.rel_pos_h", 2 * size - 1, hd)
        w(f"{p}.attn.rel_pos_w", 2 * size - 1, hd)
        w(f"{p}.mlp.lin1.weight", hidden, D)
        w(f"{p}.mlp.lin1.bias", hidden)
        w(f"{p}.mlp.lin2.weight", D, hidden)
        w(f"{p}.mlp.lin2.bias", D)
    w("image_encoder.neck.0.weight", C, D, 1, 1)
    w("image_encoder.neck.1.weight", C)
    w("image_encoder.neck.1.bias", C)
    w("image_encoder.neck.2.weight", C, C, 3, 3)
    w("image_encoder.neck.3.weight", C)
    w("image_encoder.neck.3.bias", C)

    w("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix", 2, C // 2)
    for i in range(4):
        w(f"prompt_encoder.point_embeddings.{i}.weight", 1, C)
    w("prompt_encoder.not_a_point_embed.weight", 1, C)
    w("prompt_encoder.no_mask_embed.weight", 1, C)

    def attn_ds(p, ds):
        d = C // ds
        for n in ("q", "k", "v"):
            w(f"{p}.{n}_proj.weight", d, C)
            w(f"{p}.{n}_proj.bias", d)
        w(f"{p}.out_proj.weight", C, d)
        w(f"{p}.out_proj.bias", C)

    for i in range(2):
        p = f"mask_decoder.transformer.layers.{i}"
        attn_ds(f"{p}.self_attn", 1)
        attn_ds(f"{p}.cross_attn_token_to_image", 2)
        attn_ds(f"{p}.cross_attn_image_to_token", 2)
        for n in ("norm1", "norm2", "norm3", "norm4"):
            w(f"{p}.{n}.weight", C)
            w(f"{p}.{n}.bias", C)
        w(f"{p}.mlp.lin1.weight", 8 * C, C)
        w(f"{p}.mlp.lin1.bias", 8 * C)
        w(f"{p}.mlp.lin2.weight", C, 8 * C)
        w(f"{p}.mlp.lin2.bias", C)
    attn_ds("mask_decoder.transformer.final_attn_token_to_image", 2)
    w("mask_decoder.transformer.norm_final_attn.weight", C)
    w("mask_decoder.transformer.norm_final_attn.bias", C)
    w("mask_decoder.iou_token.weight", 1, C)
    w("mask_decoder.mask_tokens.weight", 4, C)
    w("mask_decoder.output_upscaling.0.weight", C, C // 4, 2, 2)
    w("mask_decoder.output_upscaling.0.bias", C // 4)
    w("mask_decoder.output_upscaling.1.weight", C // 4)
    w("mask_decoder.output_upscaling.1.bias", C // 4)
    w("mask_decoder.output_upscaling.3.weight", C // 4, C // 8, 2, 2)
    w("mask_decoder.output_upscaling.3.bias", C // 8)
    for i in range(4):
        p = f"mask_decoder.output_hypernetworks_mlps.{i}"
        w(f"{p}.layers.0.weight", C, C)
        w(f"{p}.layers.0.bias", C)
        w(f"{p}.layers.1.weight", C, C)
        w(f"{p}.layers.1.bias", C)
        w(f"{p}.layers.2.weight", C // 8, C)
        w(f"{p}.layers.2.bias", C // 8)
    w("mask_decoder.iou_prediction_head.layers.0.weight", 256, C)
    w("mask_decoder.iou_prediction_head.layers.0.bias", 256)
    w("mask_decoder.iou_prediction_head.layers.1.weight", 256, 256)
    w("mask_decoder.iou_prediction_head.layers.1.bias", 256)
    w("mask_decoder.iou_prediction_head.layers.2.weight", 4, 256)
    w("mask_decoder.iou_prediction_head.layers.2.bias", 4)
    return out


def nnet_shapes() -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, kind) of every scannet NNET entry in
    ``synth_nnet_state_dict``'s order; kind "w" is drawn, "mean" is zeros
    and "var" ones (BatchNorm running statistics)."""
    out = []

    def w(name, *shape):
        out.append((name, shape, "w"))

    def bn(name, ch):
        w(f"{name}.weight", ch)
        w(f"{name}.bias", ch)
        out.append((f"{name}.running_mean", (ch,), "mean"))
        out.append((f"{name}.running_var", (ch,), "var"))

    E = "encoder.original_model"
    w(f"{E}.conv_stem.weight", 48, 3, 3, 3)
    bn(f"{E}.bn1", 48)
    chans = [24, 40, 64, 128, 176, 304, 512]
    kernels = [3, 3, 5, 3, 5, 5, 3]
    expands = [1, 6, 6, 6, 6, 6, 6]
    reps = [3, 5, 5, 7, 7, 9, 3]
    in_ch = 48
    for si in range(7):
        for bi in range(reps[si]):
            b = f"{E}.blocks.{si}.{bi}"
            out_ch, k = chans[si], kernels[si]
            se_ch = max(1, int(in_ch * 0.25))
            if si == 0:
                w(f"{b}.conv_dw.weight", in_ch, 1, k, k)
                bn(f"{b}.bn1", in_ch)
                w(f"{b}.se.conv_reduce.weight", se_ch, in_ch, 1, 1)
                w(f"{b}.se.conv_reduce.bias", se_ch)
                w(f"{b}.se.conv_expand.weight", in_ch, se_ch, 1, 1)
                w(f"{b}.se.conv_expand.bias", in_ch)
                w(f"{b}.conv_pw.weight", out_ch, in_ch, 1, 1)
                bn(f"{b}.bn2", out_ch)
            else:
                mid = in_ch * expands[si]
                w(f"{b}.conv_pw.weight", mid, in_ch, 1, 1)
                bn(f"{b}.bn1", mid)
                w(f"{b}.conv_dw.weight", mid, 1, k, k)
                bn(f"{b}.bn2", mid)
                w(f"{b}.se.conv_reduce.weight", se_ch, mid, 1, 1)
                w(f"{b}.se.conv_reduce.bias", se_ch)
                w(f"{b}.se.conv_expand.weight", mid, se_ch, 1, 1)
                w(f"{b}.se.conv_expand.bias", mid)
                w(f"{b}.conv_pwl.weight", out_ch, mid, 1, 1)
                bn(f"{b}.bn3", out_ch)
            in_ch = out_ch
    w(f"{E}.conv_head.weight", 2048, 512, 1, 1)
    bn(f"{E}.bn2", 2048)
    D = "decoder"
    w(f"{D}.conv2.weight", 2048, 2048, 1, 1)
    w(f"{D}.conv2.bias", 2048)
    for name, cin, cout in (("up1", 2048 + 176, 1024), ("up2", 1024 + 64, 512),
                            ("up3", 512 + 40, 256), ("up4", 256 + 24, 128)):
        w(f"{D}.{name}._net.0.weight", cout, cin, 3, 3)
        w(f"{D}.{name}._net.0.bias", cout)
        bn(f"{D}.{name}._net.1", cout)
        w(f"{D}.{name}._net.3.weight", cout, cout, 3, 3)
        w(f"{D}.{name}._net.3.bias", cout)
        bn(f"{D}.{name}._net.4", cout)
    w(f"{D}.out_conv_res8.weight", 4, 512, 3, 3)
    w(f"{D}.out_conv_res8.bias", 4)
    for head, cin in (("out_conv_res4", 516), ("out_conv_res2", 260), ("out_conv_res1", 132)):
        for j, (co, ci) in zip((0, 2, 4, 6), [(128, cin), (128, 128), (128, 128), (4, 128)]):
            w(f"{D}.{head}.{j}.weight", co, ci, 1)
            w(f"{D}.{head}.{j}.bias", co)
    return out


def _sam_scale(name: str, mask_logit_std: float) -> tuple[float, float]:
    """(offset, factor) of ``scale_like_trained``: norm weights 1 + 0.1 w,
    norm biases 0.05 w, the Fourier matrix as drawn, the rest 0.05 w;
    except the last layer of the mask hypernetworks, drawn at
    ``mask_logit_std`` (see :func:`make_weights`)."""
    if "output_hypernetworks_mlps" in name and ".layers.2." in name:
        return 0.0, mask_logit_std
    if "norm" in name or ".neck.1." in name or ".neck.3." in name or "output_upscaling.1." in name:
        return (1.0, 0.1) if name.endswith("weight") else (0.0, 0.05)
    if "gaussian" in name:
        return 0.0, 1.0
    return 0.0, 0.05


def _split(flat: torch.Tensor, shapes) -> list[torch.Tensor]:
    out, lo = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[lo:lo + n].view(shape))
        lo += n
    return out


def make_weights(config: dict, device) -> tuple[dict, dict]:
    """(SAM state dict, NNET state dict) of float32 tensors on ``device``
    for the configuration file ``config``, drawn from its
    ``weights.seed``: one standard-normal draw a net from a generator on
    ``device``, then each leaf brought to its scale in place.  The seed is
    the configuration's and not the run's, so every run of a cell does
    the same work on the same weights, its frames in another order.

    At ``scale_like_trained``'s scales alone the decoder's mask logits
    spread by about 0.2, so no candidate reaches SAM's stability threshold
    (0.9 of the pixels above -1 also above +1) and every keyframe would
    fail with no mask; the hypernetworks' last layer is drawn at
    ``config["weights"]["mask_logit_std"]`` instead, which spreads the
    logits far enough (about 200) that the threshold keeps candidates."""
    device = torch.device(device)
    sam = config["sam"]
    logit_std = config["weights"]["mask_logit_std"]
    g = torch.Generator(device=device)
    g.manual_seed(int(config["weights"]["seed"]))
    sam_entries = sam_shapes(sam)
    flat = torch.randn(sum(math.prod(s) for _, s in sam_entries), generator=g, device=device)
    sam_sd = {}
    for (name, _), t in zip(sam_entries, _split(flat, [s for _, s in sam_entries])):
        offset, factor = _sam_scale(name, logit_std)
        sam_sd[name] = t.mul_(factor).add_(offset) if (offset, factor) != (0.0, 1.0) else t
    nnet_entries = nnet_shapes()
    flat = torch.randn(sum(math.prod(s) for _, s, _ in nnet_entries), generator=g, device=device)
    nnet_sd = {}
    for (name, _, kind), t in zip(nnet_entries, _split(flat, [s for _, s, _ in nnet_entries])):
        nnet_sd[name] = t.mul_(0.05) if kind == "w" else t.fill_(0.0 if kind == "mean" else 1.0)
    return sam_sd, nnet_sd


# ------------------------------------------------------------------ frames
def _n(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


# (normal, offset, centre, in-plane axes, half extents): a shallow room
# corner and a floating panel in front of the back wall (a true depth jump)
PANELS = (
    (_n([0.08, -0.05, 1.0]), 3.2, None, None, None),
    (_n([1.0, 0.0, 0.35]), -1.1, None, None, None),
    (_n([0.0, 1.0, 0.12]), 0.95, None, None, None),
    (_n([0.15, 0.1, 1.0]), 2.0, np.asarray([0.35, -0.25, 1.93]),
     np.stack([_n([1.0, 0.0, -0.15]), _n([0.0, 1.0, -0.1])]), np.asarray([0.45, 0.35])),
)


def _hat(w):
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], np.float64)


def se3_exp(xi) -> np.ndarray:
    """SE(3) exponential of [omega, v] (float64 4x4)."""
    xi = np.asarray(xi, np.float64)
    w, v = xi[:3], xi[3:]
    th = float(np.linalg.norm(w))
    W = _hat(w)
    if th < 1e-8:
        A, B, C = 1.0, 0.5, 1.0 / 6.0
    else:
        A = math.sin(th) / th
        B = (1 - math.cos(th)) / th**2
        C = (th - math.sin(th)) / th**3
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + A * W + B * (W @ W)
    T[:3, 3] = (np.eye(3) + B * W + C * (W @ W)) @ v
    return T


def orbit_pose(k: int) -> np.ndarray:
    """Camera-to-world pose of frame ``k`` of ``PlanesSequence``'s "orbit"
    path: a bounded wander that stays inside the room for any k."""
    s = lambda A, P: A * math.sin(2 * math.pi * k / P)  # noqa: E731
    return se3_exp([s(0.08, 109), s(-0.06, 97), s(0.07, 103),
                    s(0.35, 101), s(0.22, 113), s(-0.28, 127)])


def _texture(X):
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    r = 0.5 + 0.30 * torch.sin(2.1 * x + 1.3 * y) + 0.12 * torch.sin(8.3 * y + 5.1 * z)
    g = 0.5 + 0.30 * torch.cos(1.7 * y - 2.3 * z) + 0.12 * torch.sin(7.1 * x + 4.3 * z)
    b = 0.5 + 0.30 * torch.sin(1.9 * z + 2.7 * x) + 0.12 * torch.cos(6.7 * x - 5.3 * y)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def render(poses: np.ndarray, K: np.ndarray, H: int, W: int, device):
    """(uint8 images (B, H, W, 3), depth (B, H, W) float32) of the scene
    from camera-to-world ``poses`` (B, 4, 4), ``PlanesScene.render`` in
    float64 on ``device``; the image is the [0, 1] texture scaled by 255
    and rounded down, as the frontend converts a float image."""
    dev = torch.device(device)
    T = torch.as_tensor(np.asarray(poses), dtype=torch.float64, device=dev)
    R, c = T[:, :3, :3], T[:, :3, 3]
    Kinv = torch.as_tensor(np.linalg.inv(np.asarray(K, np.float64)), device=dev)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                          torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    rays_c = torch.stack([u, v, torch.ones_like(u)], -1) @ Kinv.T            # (H, W, 3)
    rays_w = torch.einsum("hwj,bij->bhwi", rays_c, R)                        # (B, H, W, 3)
    best_t = torch.full(rays_w.shape[:3], math.inf, dtype=torch.float64, device=dev)
    for normal, d, centre, axes, half in PANELS:
        n = torch.as_tensor(normal, device=dev)
        t = (d - c @ n)[:, None, None] / (rays_w @ n)
        ok = torch.isfinite(t) & (t > 1e-3)
        if centre is not None:
            rel = c[:, None, None] + rays_w * t[..., None] - torch.as_tensor(centre, device=dev)
            a = torch.as_tensor(axes, device=dev)
            ok &= (torch.abs(rel @ a[0]) <= half[0]) & (torch.abs(rel @ a[1]) <= half[1])
        best_t = torch.where(ok & (t < best_t), t, best_t)
    hit = torch.isfinite(best_t)
    depth = torch.where(hit, best_t, torch.zeros_like(best_t))  # rays have z = 1
    X = c[:, None, None] + rays_w * torch.where(hit, best_t, torch.ones_like(best_t))[..., None]
    image = (_texture(X).to(torch.float32) * 255).to(torch.uint8)
    return image, depth.to(torch.float32)


# orbit frames between two views: distinct poses, the path's periods are 97-127 frames
VIEW_STRIDE = 8


def views(n_views: int, H: int, W: int, K: np.ndarray, device,
          batch: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """The scene from orbit frames 0, VIEW_STRIDE, ..., (n_views - 1) *
    VIEW_STRIDE: (uint8 images (n, H, W, 3), depth (n, H, W) float32) on
    the host."""
    imgs, depths = [], []
    for lo in range(0, n_views, batch):
        poses = np.stack([orbit_pose(k * VIEW_STRIDE)
                          for k in range(lo, min(lo + batch, n_views))])
        im, de = render(poses, K, H, W, device)
        imgs.append(im.cpu().numpy())
        depths.append(de.cpu().numpy())
    return np.concatenate(imgs), np.concatenate(depths)
