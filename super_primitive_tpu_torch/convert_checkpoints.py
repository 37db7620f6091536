"""Convert the published torch checkpoints to the ``.npz`` parameter trees
both packages read.

    python -m super_primitive_tpu_torch.convert_checkpoints --sam sam_vit_h_4b8939.pth \\
        --nnet scannet.pth [--out-sam sam_vit_h.npz] [--out-nnet nnet_scannet.npz] \\
        [--validate] [--image IMG] [--sam-cfg vit_h|tiny] [--device cuda|cpu]

The port's counterpart of the root ``convert_checkpoints.py``: each
checkpoint is read with ``torch.load`` (tensors only), unwrapped from its
``"model"`` entry, stripped of the ``module.`` prefix (NNET), converted by
``convert.sam_to_flax`` / ``nnet_to_flax`` and written by
``convert.save_npz_tree`` in the JAX CLI's layout: the same trees, value
for value, that ``run_sfm --sam-ckpt/--nnet-ckpt`` and
``evaluate_void`` of either package read.

``--validate`` runs each converted tree through the port's nets on one
image (``nets/validate.py``: per-stage statistics, and a layer-by-layer
diff against segment-anything / geffnet where those are installed) on
``--device`` (the card by default).  ``--image`` is a PNG or JPEG file
(decoded by the native loader); the default is a synthetic image.
``--sam-cfg tiny`` converts the tiny test encoder of the day-0 rehearsal.
The returned dict holds each validation's metrics under ``"sam"`` /
``"nnet"`` and the wall seconds of each step under ``"seconds"``
(``sam_convert``: read, convert and write; ``sam_validate``; likewise for
the NNET).
"""

from __future__ import annotations

import argparse
import time
import zipfile

import numpy as np
import torch

from .convert import nnet_to_flax, sam_to_flax, save_npz_tree, strip_module_prefix
from .nets.sam.image_encoder import VIT_H, VIT_TINY_TEST

SAM_CONFIGS = {"vit_h": VIT_H, "tiny": VIT_TINY_TEST}


def load_torch_state_dict(path) -> dict:
    """{name: numpy array} of a ``.pth`` state dict, unwrapped from a
    ``"model"`` entry.  Only tensors and plain containers are unpickled.

    A zip-format file (``torch.save``'s since PyTorch 1.6) is memory-mapped:
    its tensors are pages of the file, read when the converter touches them
    and dropped by the kernel under memory pressure, not a copy in the
    process's own memory (2.56 GB for ViT-H)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=zipfile.is_zipfile(path))
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return {k: v.numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in ckpt.items()}


def read_image(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG or JPEG file."""
    from .data.native_loader import NativeImageLoader

    with NativeImageLoader([path], num_threads=1, lookahead=1) as loader:
        return loader.rgb(0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sam", default=None, help="segment-anything .pth")
    ap.add_argument("--nnet", default=None, help="scannet NNET .pth")
    ap.add_argument("--out-sam", default="sam_vit_h.npz")
    ap.add_argument("--out-nnet", default="nnet_scannet.npz")
    ap.add_argument("--validate", action="store_true",
                    help="run the converted nets on an image; diff against the reference "
                         "torch packages where they are installed")
    ap.add_argument("--image", default=None, help="validation image (default: synthetic)")
    ap.add_argument("--sam-cfg", default="vit_h", choices=tuple(SAM_CONFIGS),
                    help="SAM encoder; 'tiny' for the day-0 rehearsal")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = None
    if args.validate:
        from .run_sfm import require_device

        device = require_device(args.device)
    image = read_image(args.image) if args.image else None
    results = {"seconds": {}}
    seconds = results["seconds"]
    if args.sam:
        t0 = time.perf_counter()
        tree = sam_to_flax(load_torch_state_dict(args.sam),
                           depth=SAM_CONFIGS[args.sam_cfg].depth)
        save_npz_tree(args.out_sam, tree)
        seconds["sam_convert"] = time.perf_counter() - t0
        print(f"SAM -> {args.out_sam} ({seconds['sam_convert']:.1f} s)")
        if args.validate:
            from .nets.validate import validate_sam

            t0 = time.perf_counter()
            results["sam"] = validate_sam(tree, ckpt_path=args.sam, image=image, device=device)
            seconds["sam_validate"] = time.perf_counter() - t0
        del tree
    if args.nnet:
        t0 = time.perf_counter()
        tree = nnet_to_flax(strip_module_prefix(load_torch_state_dict(args.nnet)))
        save_npz_tree(args.out_nnet, tree)
        seconds["nnet_convert"] = time.perf_counter() - t0
        print(f"NNET -> {args.out_nnet} ({seconds['nnet_convert']:.1f} s)")
        if args.validate:
            from .nets.validate import validate_nnet

            t0 = time.perf_counter()
            results["nnet"] = validate_nnet(tree, ckpt_path=args.nnet, image=image,
                                            device=device)
            seconds["nnet_validate"] = time.perf_counter() - t0
    return results


if __name__ == "__main__":
    main()
