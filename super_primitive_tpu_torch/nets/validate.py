"""Validation of converted checkpoints through the port's nets.

Port of ``super_primitive_tpu/nets/validate.py``.  Given a converted
parameter tree (the ``.npz`` trees ``convert_checkpoints`` writes), each
function runs it on one image and prints per-stage statistics, in two
tiers:

1. The port (always): the tree through the full predictor, SAM's
   ``set_image`` and ``predict_batched_points``, or the NNET's
   ``predict_normals``; mean, std, largest magnitude and a finite flag per
   stage, so a transposed kernel or a wrong BatchNorm statistic shows as
   an implausible distribution rather than a silently wrong mask.
2. The reference torch packages (when ``segment_anything`` / ``geffnet``
   import): the original model runs the same image from the ``.pth``, and
   the embeddings, encoder blocks, mask logits or normals are diffed.

Each prints which tier ran.  Both run float32 on ``device``, with TF32
off (``utils.numerics.float32_matmuls``).
"""

from __future__ import annotations

import importlib.util

import numpy as np
import torch

from ..convert import nnet_from_flax, nnet_state_dict, sam_from_flax
from ..utils.numerics import float32_matmuls
from .nnet import NNET, predict_normals
from .sam.image_encoder import config_from_state_dict
from .sam.predictor import SamPredictor


def _stat(name: str, x) -> str:
    x = np.asarray(x, np.float64)
    return (f"  {name:<38s} shape={tuple(x.shape)!s:<22s} mean={x.mean():+.4f} "
            f"std={x.std():.4f} absmax={np.abs(x).max():.4f} finite={bool(np.isfinite(x).all())}")


def sample_image(hw=(480, 640)) -> np.ndarray:
    """A deterministic structured uint8 RGB image (blobs and a gradient)."""
    H, W = hw
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    img = np.stack([0.5 + 0.4 * np.sin(u * 0.05) * np.cos(v * 0.04),
                    0.5 + 0.4 * np.cos(u * 0.03 + v * 0.02),
                    np.clip((u + v) / (H + W), 0, 1)], -1)
    return (img * 255).astype(np.uint8)


def _grid_points(hw, n: int = 3) -> np.ndarray:
    H, W = hw
    ys = np.linspace(0.2, 0.8, n) * H
    xs = np.linspace(0.2, 0.8, n) * W
    return np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)


def _reference_importable(*names: str) -> str | None:
    """The first of ``names`` that does not import, or None."""
    for n in names:
        if importlib.util.find_spec(n) is None:
            return n
    return None


def validate_sam(tree: dict, ckpt_path: str | None = None, image: np.ndarray | None = None,
                 device: str | torch.device = "cuda") -> dict:
    """Run a converted SAM tree through the port's predictor; diff it
    against segment-anything's on the ``.pth`` when that imports.  Returns
    the metrics printed, with ``"tier"`` 1 or 2."""
    float32_matmuls()
    sd = sam_from_flax(tree)
    cfg = config_from_state_dict(sd)
    image = sample_image() if image is None else image
    pts = _grid_points(image.shape[:2])
    predictor = SamPredictor(sd, cfg, device=device)
    predictor.set_image(image)
    feats = predictor._features.cpu().numpy()
    print(f"[port] SAM forward on {torch.device(device)}:")
    print(_stat("image_embedding", feats))
    logits, iou = predictor.predict_batched_points(pts)
    print(_stat("mask_logits", logits))
    print(_stat("iou_pred", iou))
    areas = (logits > 0).mean(axis=(-2, -1))
    print(f"  mask area fractions per prompt (3 scales): {np.round(areas, 3).tolist()}")
    result = {"tier": 1, "embed_std": float(feats.std()), "iou": iou.tolist(),
              "finite": bool(np.isfinite(feats).all() and np.isfinite(logits).all()
                             and np.isfinite(iou).all())}

    missing = _reference_importable("segment_anything")
    if missing is not None:
        print(f"[torch] reference cross-check skipped ({missing} is not installed); "
              "tier 1 (the port alone) ran")
        return result
    if ckpt_path is None:
        raise ValueError("the reference cross-check needs the original .pth path")
    from segment_anything import SamPredictor as RefPredictor
    from segment_anything import sam_model_registry

    name = {1280: "vit_h", 1024: "vit_l", 768: "vit_b"}[cfg.embed_dim]
    ref = sam_model_registry[name](checkpoint=ckpt_path).to(device).eval()
    ref_pred = RefPredictor(ref)
    blocks = sorted({0, cfg.depth // 2, cfg.depth - 1})
    taps: dict = {}

    def hook(key):
        def f(_m, _i, o):
            taps[key] = o.detach().float().cpu().numpy()
        return f

    hooks = [m.image_encoder.blocks[i].register_forward_hook(hook((side, i)))
             for side, m in (("ref", ref), ("port", predictor.model)) for i in blocks]
    with torch.no_grad():
        ref_pred.set_image(image)
        predictor._features = None
        predictor.set_image(image)
    for h in hooks:
        h.remove()
    print("[torch] reference cross-check (tier 2):")
    ref_feats = ref_pred.features.cpu().numpy()[0]
    err = float(np.abs(np.moveaxis(feats[0], -1, 0) - ref_feats).max())
    print(f"  image_embedding max abs diff: {err:.3e}")
    result.update(tier=2, embed_max_abs_diff=err)
    for i in blocks:
        err = float(np.abs(taps[("port", i)] - taps[("ref", i)]).max())
        print(f"  block_{i} max abs diff: {err:.3e}")
        result[f"block_{i}_max_abs_diff"] = err
    with torch.no_grad():
        coords = torch.as_tensor(ref_pred.transform.apply_coords(pts[:, None, :], image.shape[:2]),
                                 device=device, dtype=torch.float32)
        labels = torch.ones(coords.shape[:2], device=device)
        ref_masks, ref_iou, _ = ref_pred.predict_torch(coords, labels, multimask_output=True)
    ref_masks, ref_iou = ref_masks.cpu().numpy(), ref_iou.cpu().numpy()
    mine = logits > 0
    mask_iou = (mine & ref_masks).sum(axis=(-2, -1)) / np.maximum(
        (mine | ref_masks).sum(axis=(-2, -1)), 1)
    iou_err = float(np.abs(iou - ref_iou).max())
    print(f"  per-prompt mask IoU (port vs reference): min={mask_iou.min():.4f} "
          f"mean={mask_iou.mean():.4f}")
    print(f"  iou_pred max abs diff: {iou_err:.3e}")
    result.update(mask_iou_min=float(mask_iou.min()), iou_pred_max_abs_diff=iou_err)
    return result


def validate_nnet(tree: dict, ckpt_path: str | None = None, image: np.ndarray | None = None,
                  network_dim=(480, 640), device: str | torch.device = "cuda") -> dict:
    """Run a converted NNET tree through the port's ``predict_normals``;
    diff it against the reference scannet model on the ``.pth`` when
    ``geffnet`` and the reference's model module import."""
    float32_matmuls()
    image = sample_image() if image is None else image
    model = NNET()
    model.load_state_dict(nnet_state_dict(nnet_from_flax(tree)))
    model = model.to(device).eval().requires_grad_(False)
    normals, kappa = predict_normals(model, image, tuple(network_dim))
    normals, kappa = normals.cpu().numpy(), kappa.cpu().numpy()
    print(f"[port] NNET forward on {torch.device(device)}:")
    print(_stat("normals", normals))
    print(_stat("kappa", kappa))
    norm_len = np.linalg.norm(normals, axis=-1)
    print(f"  |n| range: [{norm_len.min():.4f}, {norm_len.max():.4f}] (should be ~1)")
    result = {"tier": 1, "norm_len_mean": float(norm_len.mean()),
              "finite": bool(np.isfinite(normals).all() and np.isfinite(kappa).all())}

    missing = _reference_importable("geffnet", "frontend")
    if missing is not None:
        print(f"[torch] reference cross-check skipped ({missing} is not installed); "
              "tier 1 (the port alone) ran")
        return result
    if ckpt_path is None:
        raise ValueError("the reference cross-check needs the original .pth path")
    from frontend.normals.scannet_model import NNET as RefNNET

    ref = RefNNET({"architecture": "BN"}).eval()
    sd = torch.load(ckpt_path, map_location="cpu")
    sd = sd["model"] if "model" in sd else sd
    ref.load_state_dict({k.replace("module.", ""): v for k, v in sd.items()})
    ref = ref.to(device)
    img01 = torch.as_tensor(image.astype(np.float32) / 255.0, device=device).permute(2, 0, 1)[None]
    mean = torch.tensor([0.485, 0.456, 0.406], device=device).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225], device=device).view(1, 3, 1, 1)
    x = torch.nn.functional.interpolate(img01, size=tuple(network_dim), mode="bilinear",
                                        align_corners=True)
    with torch.no_grad():
        out = ref((x - mean) / std)[-1][-1]
    out = torch.nn.functional.interpolate(out, size=image.shape[:2], mode="bilinear",
                                          align_corners=True)[0].permute(1, 2, 0).cpu().numpy()
    n_err = float(np.abs(out[..., :3] - normals).max())
    k_err = float(np.abs(out[..., 3:] - kappa).max())
    print("[torch] reference cross-check (tier 2):")
    print(f"  normals max abs diff: {n_err:.3e}; kappa: {k_err:.3e}")
    result.update(tier=2, normals_max_abs_diff=n_err, kappa_max_abs_diff=k_err)
    return result
