"""A cell of each configuration at a size the CPU runs in seconds, for the
tests: the real configuration with a two-block SAM of width 32 on the
published 64 x 64 token grid, 192 x 256 frames and fewer prompts.  The
integration shape is the selection's mask grid (192 x 256), so that a
one-row mask is not lost to the nearest resize."""

from __future__ import annotations

import copy

from portbench import spec

# the tiny decoder's 2 upscaled channels need a larger hypernetwork output
# for its logits to spread as a trained SAM's do
TINY_LOGIT_STD = 5000.0
TINY_SAM = {"img_size": 1024, "patch_size": 16, "embed_dim": 32, "depth": 2, "num_heads": 2,
            "mlp_ratio": 4.0, "window_size": 14, "global_attn_indexes": [1], "out_chans": 16}


def tiny_cell(name: str) -> dict:
    """``name``'s cell (``spec.cell``) shrunk for the CPU."""
    cell = copy.deepcopy(spec.cell(spec.load(), name))
    cfg, wl = cell["config"], cell["workload"]
    cfg["sam"] = dict(TINY_SAM)
    cfg["weights"]["mask_logit_std"] = TINY_LOGIT_STD
    cfg["image_hw"] = [192, 256]
    cfg["K"] = [[208.0, 0.0, 128.0], [0.0, 208.0, 96.0], [0.0, 0.0, 1.0]]
    fc = cfg["program"]["frontend"]
    fc["normals"]["network_dim"] = [96, 128]
    fc["normals"]["integration_shape"] = [192, 256]
    fc["num_pts"], fc["num_pts_active"] = 24, 8
    fc["cg_max_iter"] = min(fc["cg_max_iter"], 200)
    cfg["program"]["sam_params"]["infer_resolution"] = [96, 128]
    if "sparse_points" in wl:
        wl["sparse_points"] = 24
    # the limits at this size, between CPU readings of the program on seeds
    # 1, 2, 3, 2**31 + 1 and 987654321 (sam_feat_err <= 0.0113, decoder_err
    # <= 0.839, bini_err <= 0.0012) and of the control (>= 0.0858, 0.986,
    # 3.46); a decoder of width 16 in bf16 is not separated from float8,
    # so here the control fails on the features and BiNI
    wl["limits"].update(sam_feat_err=0.04, decoder_err=0.95, bini_err=0.01)
    return cell
