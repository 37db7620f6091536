"""Carry the JAX package's state and weights into the port.

``from_jax_arrays`` turns numpy copies of the JAX package's keyframe dict,
``SegmentGeometry``, ``PointBundle`` and ``OptParams`` into the port's
tensors on a given device, so both packages can solve the same problem.
Every input is a mapping from field name to an array (``np.asarray`` of the
JAX leaf); this module imports nothing of JAX.

``sam_from_flax`` and ``nnet_from_flax`` turn the JAX package's numpy
parameter trees (``nets/convert.convert_sam`` / ``convert_nnet``, the
``"tree"`` of the ``.npz`` files ``convert_checkpoints.py`` writes, read by
``load_npz_tree``) into state dicts of the port's modules, whose parameters
carry the published torch names: the inverse of the JAX converter's
layouts (Dense kernels transposed, conv kernels (kh, kw, in, out) ->
(out, in, kh, kw), the ConvTranspose kernels flipped back, the Conv1d refine
heads from 1x1 convs, BatchNorm statistics from ``batch_stats``).

``sam_to_flax`` and ``nnet_to_flax`` are the port's copies of that JAX
converter (published state dict -> tree), and ``save_npz_tree`` writes a
tree as ``convert_checkpoints.py`` does, so the port can make the ``.npz``
files its CLIs read (``chip_smoke.py`` does, from ``nets/synth.py``
weights).
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Mapping, Optional

import numpy as np
import torch

from .keyframe import PointBundle, SegmentGeometry
from .solve.retraction_adam import OptParams

KEYFRAME_FIELDS = ("regions", "logdepth_perseg", "keypoints_rc", "K", "image")


def _t(x, device, dtype=None) -> torch.Tensor:
    a = np.asarray(x)
    if dtype is None:
        dtype = {np.dtype(bool): torch.bool, np.dtype(np.float64): torch.float32}.get(
            a.dtype, None
        )
    t = torch.from_numpy(np.array(a))  # a copy: JAX-backed arrays are read-only
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def from_jax_arrays(
    device: str | torch.device = "cuda",
    *,
    keyframe: Optional[Mapping] = None,
    geo: Optional[Mapping] = None,
    bundle: Optional[Mapping] = None,
    opt: Optional[Mapping] = None,
) -> dict:
    """Port tensors on ``device`` from the JAX package's arrays.

    - ``keyframe``: the frontend dict (regions, logdepth_perseg,
      keypoints_rc, K, image) -> dict of tensors;
    - ``geo``: SegmentGeometry fields (keypoints, logdepth, regions,
      seg_valid) -> :class:`SegmentGeometry`;
    - ``bundle``: PointBundle fields (uv, seg_id, base_logdepth, valid,
      num_valid) -> :class:`PointBundle`;
    - ``opt``: OptParams fields (poses, xi, kp_logdepth; ``affine`` is not
      used by the ported solve) -> :class:`OptParams`.

    Returns a dict with a key for each given input.  float64 arrays become
    float32; integer ids become int64."""
    out = {}
    if keyframe is not None:
        out["keyframe"] = {
            k: _t(keyframe[k], device, torch.int64 if k == "keypoints_rc" else None)
            for k in KEYFRAME_FIELDS
        }
    if geo is not None:
        out["geo"] = SegmentGeometry(
            keypoints=_t(geo["keypoints"], device, torch.float32),
            logdepth=_t(geo["logdepth"], device, torch.float32),
            regions=_t(geo["regions"], device, torch.bool),
            seg_valid=_t(geo["seg_valid"], device, torch.bool),
        )
    if bundle is not None:
        out["bundle"] = PointBundle(
            uv=_t(bundle["uv"], device, torch.float32),
            seg_id=_t(bundle["seg_id"], device, torch.int64),
            base_logdepth=_t(bundle["base_logdepth"], device, torch.float32),
            valid=_t(bundle["valid"], device, torch.bool),
            num_valid=int(np.asarray(bundle["num_valid"])),
        )
    if opt is not None:
        out["opt"] = OptParams(
            poses=_t(opt["poses"], device, torch.float32),
            xi=_t(opt["xi"], device, torch.float32),
            kp_logdepth=_t(opt["kp_logdepth"], device, torch.float32),
        )
    return out


def load_npz_tree(path) -> dict:
    """The parameter tree stored under ``"tree"`` in a converted ``.npz``
    (``convert_checkpoints.py``'s output)."""
    with np.load(path, allow_pickle=True) as f:
        return f["tree"].item()


def _w(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _linear(sd, name, p):
    sd[f"{name}.weight"] = _w(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _w(p["bias"])


def _conv(sd, name, p):
    sd[f"{name}.weight"] = _w(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{name}.bias"] = _w(p["bias"])


def _norm(sd, name, p, stats=None):
    sd[f"{name}.weight"] = _w(p["scale"] if "scale" in p else p["weight"])
    sd[f"{name}.bias"] = _w(p["bias"])
    if stats is not None:
        sd[f"{name}.running_mean"] = _w(stats["mean"])
        sd[f"{name}.running_var"] = _w(stats["var"])


def sam_from_flax(tree: dict) -> dict:
    """State dict (segment-anything names) of ``nets.sam.predictor.Sam``
    from the JAX package's {image_encoder, prompt_encoder, mask_decoder}
    tree."""
    sd: dict = {}
    enc = tree["image_encoder"]
    E = "image_encoder"
    _conv(sd, f"{E}.patch_embed.proj", enc["patch_embed"])
    sd[f"{E}.pos_embed"] = _w(enc["pos_embed"])
    depth = sum(1 for k in enc if k.startswith("block"))
    for i in range(depth):
        b, p = enc[f"block{i}"], f"{E}.blocks.{i}"
        _norm(sd, f"{p}.norm1", b["norm1"])
        _norm(sd, f"{p}.norm2", b["norm2"])
        _linear(sd, f"{p}.attn.qkv", b["attn"]["qkv"])
        _linear(sd, f"{p}.attn.proj", b["attn"]["proj"])
        sd[f"{p}.attn.rel_pos_h"] = _w(b["attn"]["rel_pos_h"])
        sd[f"{p}.attn.rel_pos_w"] = _w(b["attn"]["rel_pos_w"])
        _linear(sd, f"{p}.mlp.lin1", b["mlp_lin1"])
        _linear(sd, f"{p}.mlp.lin2", b["mlp_lin2"])
    _conv(sd, f"{E}.neck.0", enc["neck_conv1"])
    _norm(sd, f"{E}.neck.1", enc["neck_ln1"])
    _conv(sd, f"{E}.neck.2", enc["neck_conv2"])
    _norm(sd, f"{E}.neck.3", enc["neck_ln2"])

    pe, P = tree["prompt_encoder"], "prompt_encoder"
    sd[f"{P}.pe_layer.positional_encoding_gaussian_matrix"] = _w(
        pe["pe_layer"]["positional_encoding_gaussian_matrix"])
    for i in range(4):
        sd[f"{P}.point_embeddings.{i}.weight"] = _w(pe[f"point_embed_{i}"])[None]
    sd[f"{P}.not_a_point_embed.weight"] = _w(pe["not_a_point_embed"])[None]
    sd[f"{P}.no_mask_embed.weight"] = _w(pe["no_mask_embed"])[None]

    dec, D = tree["mask_decoder"], "mask_decoder"

    def attn_ds(name, p):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, f"{name}.{proj}", p[proj])

    tr = dec["transformer"]
    for i in range(sum(1 for k in tr if k.startswith("layer"))):
        lay, p = tr[f"layer{i}"], f"{D}.transformer.layers.{i}"
        for a in ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token"):
            attn_ds(f"{p}.{a}", lay[a])
        for n in ("norm1", "norm2", "norm3", "norm4"):
            _norm(sd, f"{p}.{n}", lay[n])
        _linear(sd, f"{p}.mlp.lin1", lay["mlp_lin1"])
        _linear(sd, f"{p}.mlp.lin2", lay["mlp_lin2"])
    attn_ds(f"{D}.transformer.final_attn_token_to_image", tr["final_attn_token_to_image"])
    _norm(sd, f"{D}.transformer.norm_final_attn", tr["norm_final_attn"])
    sd[f"{D}.iou_token.weight"] = _w(dec["iou_token"])
    sd[f"{D}.mask_tokens.weight"] = _w(dec["mask_tokens"])
    for j, key in ((0, "upscale_conv1"), (3, "upscale_conv2")):
        # flax (kh, kw, in, out), spatially flipped -> torch (in, out, kh, kw)
        k = np.asarray(dec[key]["kernel"])[::-1, ::-1]
        sd[f"{D}.output_upscaling.{j}.weight"] = _w(k.transpose(2, 3, 0, 1))
        sd[f"{D}.output_upscaling.{j}.bias"] = _w(dec[key]["bias"])
    _norm(sd, f"{D}.output_upscaling.1", dec["upscale_ln"])
    for i in range(sum(1 for k in dec if k.startswith("hypernet"))):
        for j in range(3):
            _linear(sd, f"{D}.output_hypernetworks_mlps.{i}.layers.{j}",
                    dec[f"hypernet{i}"][f"layers{j}"])
    for j in range(3):
        _linear(sd, f"{D}.iou_prediction_head.layers.{j}", dec["iou_head"][f"layers{j}"])
    return sd


def nnet_from_flax(tree: dict) -> dict:
    """State dict (scannet names) of ``nets.nnet.NNET`` from the JAX
    package's {params, batch_stats} tree."""
    sd: dict = {}
    params, stats = tree["params"], tree["batch_stats"]
    enc, enc_s = params["encoder"], stats["encoder"]
    E = "encoder.original_model"
    _conv(sd, f"{E}.conv_stem", enc["stem"]["conv"])
    _norm(sd, f"{E}.bn1", enc["stem"]["bn"], enc_s["stem"]["bn"])
    blocks = sorted((tuple(int(v) for v in k.split("_")[1:]), k)
                    for k in enc if k.startswith("blocks_"))
    for (si, bi), key in blocks:
        p, s, b = enc[key], enc_s[key], f"{E}.blocks.{si}.{bi}"
        _conv(sd, f"{b}.se.conv_reduce", p["se"]["conv_reduce"])
        _conv(sd, f"{b}.se.conv_expand", p["se"]["conv_expand"])
        _conv(sd, f"{b}.conv_dw", p["dw_conv"])
        if si == 0:  # DepthwiseSeparable: conv_dw/bn1, se, conv_pw/bn2
            _norm(sd, f"{b}.bn1", p["dw_bn"], s["dw_bn"])
            _conv(sd, f"{b}.conv_pw", p["pw"]["conv"])
            _norm(sd, f"{b}.bn2", p["pw"]["bn"], s["pw"]["bn"])
        else:  # InvertedResidual: conv_pw/bn1, conv_dw/bn2, se, conv_pwl/bn3
            _conv(sd, f"{b}.conv_pw", p["pw"]["conv"])
            _norm(sd, f"{b}.bn1", p["pw"]["bn"], s["pw"]["bn"])
            _norm(sd, f"{b}.bn2", p["dw_bn"], s["dw_bn"])
            _conv(sd, f"{b}.conv_pwl", p["pwl"]["conv"])
            _norm(sd, f"{b}.bn3", p["pwl"]["bn"], s["pwl"]["bn"])
    _conv(sd, f"{E}.conv_head", enc["head_conv"])

    D = "decoder"
    _conv(sd, f"{D}.conv2", params["conv2"])
    for up in ("up1", "up2", "up3", "up4"):
        p, s = params[up], stats[up]
        _conv(sd, f"{D}.{up}._net.0", p["conv0"])
        _norm(sd, f"{D}.{up}._net.1", p["bn0"], s["bn0"])
        _conv(sd, f"{D}.{up}._net.3", p["conv1"])
        _norm(sd, f"{D}.{up}._net.4", p["bn1"], s["bn1"])
    _conv(sd, f"{D}.out_conv_res8", params["out_conv_res8"])
    for head in ("out_conv_res4", "out_conv_res2", "out_conv_res1"):
        for j in range(4):
            p = params[head][f"conv{j}"]
            sd[f"{D}.{head}.{2 * j}.weight"] = _w(np.asarray(p["kernel"])[0, 0].T[:, :, None])
            sd[f"{D}.{head}.{2 * j}.bias"] = _w(p["bias"])
    return sd


def strip_module_prefix(sd: dict) -> dict:
    """A state dict without the ``module.`` prefix that the published
    scannet checkpoint puts on every key (the reference saved a
    DataParallel model)."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def nnet_state_dict(sd) -> dict:
    """A published scannet state dict as ``nets.nnet.NNET`` loads it: the
    ``module.`` prefix stripped, and without the encoder's bn2 (it feeds
    only the removed classifier) and BatchNorm batch counters."""
    out = {}
    for k, v in strip_module_prefix(sd).items():
        if k.startswith("encoder.original_model.bn2.") or k.endswith("num_batches_tracked"):
            continue
        out[k] = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    return out


def save_npz_tree(path, tree: dict):
    """Write ``tree`` under ``"tree"`` in an ``.npz``, the layout
    ``convert_checkpoints.py`` writes (it compresses; float weights hardly
    compress, so this does not), which ``load_npz_tree`` reads.

    The entry is the one ``np.savez`` writes, a 0-d object array pickled
    with protocol 4, but the pickler keeps no memo: ``np.savez``'s holds a
    copy of every leaf's bytes until the dump ends, which doubles the
    process's memory for a ViT-H tree.  Here each leaf's bytes are freed
    once written.  The tree holds no object twice."""
    path = os.fspath(path)
    if not path.endswith(".npz"):
        path += ".npz"  # as np.savez names it
    arr = np.empty((), dtype=object)
    arr[()] = tree
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf, \
            zf.open("tree.npy", "w", force_zip64=True) as fid:
        np.lib.format.write_array_header_1_0(fid, np.lib.format.header_data_from_array_1_0(arr))
        pickler = pickle.Pickler(fid, protocol=4)
        pickler.fast = True
        pickler.dump(arr)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _dense_tree(sd, name):
    return {"kernel": _np(sd[f"{name}.weight"]).T, "bias": _np(sd[f"{name}.bias"])}


def _conv_tree(sd, name, bias=True):
    out = {"kernel": _np(sd[f"{name}.weight"]).transpose(2, 3, 1, 0)}
    if bias:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def _conv_transpose_tree(sd, name):
    w = _np(sd[f"{name}.weight"]).transpose(2, 3, 0, 1)[::-1, ::-1]
    return {"kernel": np.ascontiguousarray(w), "bias": _np(sd[f"{name}.bias"])}


def _ln_tree(sd, name, key="scale"):
    return {key: _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


def _bn_tree(sd, name):
    return (_ln_tree(sd, name),
            {"mean": _np(sd[f"{name}.running_mean"]), "var": _np(sd[f"{name}.running_var"])})


def sam_to_flax(sd: dict, depth: int = 32) -> dict:
    """The JAX package's SAM tree from a segment-anything state dict
    (``nets/convert.convert_sam``); ``depth`` ViT blocks."""
    E = "image_encoder"
    enc: dict = {"patch_embed": _conv_tree(sd, f"{E}.patch_embed.proj"),
                 "pos_embed": _np(sd[f"{E}.pos_embed"])}
    for i in range(depth):
        p = f"{E}.blocks.{i}"
        enc[f"block{i}"] = {
            "norm1": _ln_tree(sd, f"{p}.norm1"),
            "norm2": _ln_tree(sd, f"{p}.norm2"),
            "attn": {"qkv": _dense_tree(sd, f"{p}.attn.qkv"),
                     "proj": _dense_tree(sd, f"{p}.attn.proj"),
                     "rel_pos_h": _np(sd[f"{p}.attn.rel_pos_h"]),
                     "rel_pos_w": _np(sd[f"{p}.attn.rel_pos_w"])},
            "mlp_lin1": _dense_tree(sd, f"{p}.mlp.lin1"),
            "mlp_lin2": _dense_tree(sd, f"{p}.mlp.lin2"),
        }
    enc["neck_conv1"] = _conv_tree(sd, f"{E}.neck.0", bias=False)
    enc["neck_ln1"] = _ln_tree(sd, f"{E}.neck.1", "weight")
    enc["neck_conv2"] = _conv_tree(sd, f"{E}.neck.2", bias=False)
    enc["neck_ln2"] = _ln_tree(sd, f"{E}.neck.3", "weight")

    P = "prompt_encoder"
    pe: dict = {
        "pe_layer": {"positional_encoding_gaussian_matrix":
                     _np(sd[f"{P}.pe_layer.positional_encoding_gaussian_matrix"])},
        "not_a_point_embed": _np(sd[f"{P}.not_a_point_embed.weight"])[0],
        "no_mask_embed": _np(sd[f"{P}.no_mask_embed.weight"])[0],
    }
    for i in range(4):
        pe[f"point_embed_{i}"] = _np(sd[f"{P}.point_embeddings.{i}.weight"])[0]

    def attn_ds(p):
        return {proj: _dense_tree(sd, f"{p}.{proj}")
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj")}

    D = "mask_decoder"
    dec: dict = {
        "iou_token": _np(sd[f"{D}.iou_token.weight"]),
        "mask_tokens": _np(sd[f"{D}.mask_tokens.weight"]),
        "upscale_conv1": _conv_transpose_tree(sd, f"{D}.output_upscaling.0"),
        "upscale_ln": _ln_tree(sd, f"{D}.output_upscaling.1", "weight"),
        "upscale_conv2": _conv_transpose_tree(sd, f"{D}.output_upscaling.3"),
        "iou_head": {f"layers{j}": _dense_tree(sd, f"{D}.iou_prediction_head.layers.{j}")
                     for j in range(3)},
    }
    for i in range(4):
        dec[f"hypernet{i}"] = {
            f"layers{j}": _dense_tree(sd, f"{D}.output_hypernetworks_mlps.{i}.layers.{j}")
            for j in range(3)}
    tr: dict = {}
    for i in range(2):
        p = f"{D}.transformer.layers.{i}"
        tr[f"layer{i}"] = {
            **{a: attn_ds(f"{p}.{a}") for a in
               ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token")},
            **{n: _ln_tree(sd, f"{p}.{n}") for n in ("norm1", "norm2", "norm3", "norm4")},
            "mlp_lin1": _dense_tree(sd, f"{p}.mlp.lin1"),
            "mlp_lin2": _dense_tree(sd, f"{p}.mlp.lin2"),
        }
    tr["final_attn_token_to_image"] = attn_ds(f"{D}.transformer.final_attn_token_to_image")
    tr["norm_final_attn"] = _ln_tree(sd, f"{D}.transformer.norm_final_attn")
    dec["transformer"] = tr
    return {"image_encoder": enc, "prompt_encoder": pe, "mask_decoder": dec}


B5_REPEATS = (3, 5, 5, 7, 7, 9, 3)


def nnet_to_flax(sd: dict) -> dict:
    """The JAX package's NNET {params, batch_stats} tree from a scannet state
    dict (``nets/convert.convert_nnet``)."""
    E, D = "encoder.original_model", "decoder"
    enc_p: dict = {}
    enc_s: dict = {}
    p_bn, s_bn = _bn_tree(sd, f"{E}.bn1")
    enc_p["stem"] = {"conv": _conv_tree(sd, f"{E}.conv_stem", bias=False), "bn": p_bn}
    enc_s["stem"] = {"bn": s_bn}
    for si, reps in enumerate(B5_REPEATS):
        for bi in range(reps):
            b, dst = f"{E}.blocks.{si}.{bi}", f"blocks_{si}_{bi}"
            se = {"conv_reduce": _conv_tree(sd, f"{b}.se.conv_reduce"),
                  "conv_expand": _conv_tree(sd, f"{b}.se.conv_expand")}
            dw = _conv_tree(sd, f"{b}.conv_dw", bias=False)
            p1, s1 = _bn_tree(sd, f"{b}.bn1")
            p2, s2 = _bn_tree(sd, f"{b}.bn2")
            if si == 0:  # DepthwiseSeparable: conv_dw/bn1, se, conv_pw/bn2
                enc_p[dst] = {"dw_conv": dw, "dw_bn": p1, "se": se,
                              "pw": {"conv": _conv_tree(sd, f"{b}.conv_pw", bias=False),
                                     "bn": p2}}
                enc_s[dst] = {"dw_bn": s1, "pw": {"bn": s2}}
            else:  # InvertedResidual: conv_pw/bn1, conv_dw/bn2, se, conv_pwl/bn3
                p3, s3 = _bn_tree(sd, f"{b}.bn3")
                enc_p[dst] = {"pw": {"conv": _conv_tree(sd, f"{b}.conv_pw", bias=False),
                                     "bn": p1},
                              "dw_conv": dw, "dw_bn": p2, "se": se,
                              "pwl": {"conv": _conv_tree(sd, f"{b}.conv_pwl", bias=False),
                                      "bn": p3}}
                enc_s[dst] = {"pw": {"bn": s1}, "dw_bn": s2, "pwl": {"bn": s3}}
    enc_p["head_conv"] = _conv_tree(sd, f"{E}.conv_head", bias=False)
    params: dict = {"encoder": enc_p, "conv2": _conv_tree(sd, f"{D}.conv2")}
    stats: dict = {"encoder": enc_s}
    for up in ("up1", "up2", "up3", "up4"):
        p0, s0 = _bn_tree(sd, f"{D}.{up}._net.1")
        p1, s1 = _bn_tree(sd, f"{D}.{up}._net.4")
        params[up] = {"conv0": _conv_tree(sd, f"{D}.{up}._net.0"), "bn0": p0,
                      "conv1": _conv_tree(sd, f"{D}.{up}._net.3"), "bn1": p1}
        stats[up] = {"bn0": s0, "bn1": s1}
    params["out_conv_res8"] = _conv_tree(sd, f"{D}.out_conv_res8")

    def conv1d(name):  # (out, in, 1) -> (1, 1, in, out)
        w = _np(sd[f"{name}.weight"])
        return {"kernel": w[:, :, 0].T.reshape(1, 1, w.shape[1], w.shape[0]),
                "bias": _np(sd[f"{name}.bias"])}

    for head in ("out_conv_res4", "out_conv_res2", "out_conv_res1"):
        params[head] = {f"conv{j}": conv1d(f"{D}.{head}.{2 * j}") for j in range(4)}
    return {"params": params, "batch_stats": stats}
