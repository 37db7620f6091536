"""The comparison that decides ``correct``: what the timed path produced on
the sampled frames, against the plain reference under ``reference/``.

The reference gets the same inputs (the frame, the intrinsics, the sparse
depth, and the weights drawn again from the configuration's seed) and
works out the frame again along its own chain, each stage on what its own
stage before produced:

- ``normals_err``: the NNET's normals at the integration shape, largest
  absolute difference (unit vectors);
- ``sam_feat_err``: the SAM encoder's features, largest difference over
  the reference's largest magnitude;
- ``decoder_err``: the decoder's low-res logits and IoU of every round 1
  prompt, each side on its own features, the larger of the two relative
  differences;
- ``select_chain_pct``: the smallest-good pick of every round 1 prompt on
  each side's own decoder outputs: the share of prompts, in %, that one
  side keeps and the other drops, or whose picked candidate differs;
- ``bini_err``: BiNI on the reference's own normals, inside the program's
  masks: largest log-depth difference from the program's per-segment
  depths;
- ``kf_chain_pct``: the keyframe's last steps on the reference's own
  per-segment depths: the share of the keyframe's covered pixels, in %,
  covered on one side only or whose overlap-averaged log-depth differs by
  more than :data:`LOG_TOL`;
- ``completion_chain_pct`` (depth completion): the alignment and overlap
  average on that keyframe: the share of pixels, in %, valid on one side
  only or whose log-depth differs by more than :data:`LOG_TOL`.

Past each discrete choice (which masks survive, where a segment splits)
the two chains can part on rounding alone, so beside them each such stage
is also replayed exactly on the program's own state, the stage before as
the program left it:

- ``select_mismatch``: the selection replayed on the program's decoder
  outputs (plain K3 counts, the smallest-good pick, NMS, round 2's prompts
  drawn again): prompts, masks and keypoints that differ, counted;
- ``kf_mismatch``: the keyframe's last steps replayed on the program's
  per-segment depths: region pixels, log-depths and keypoints that
  differ, counted;
- ``completion_mismatch`` (depth completion): the alignment and overlap
  average replayed on the program's keyframe: dense depth and invalid
  pixels that differ, counted.

The chains start from the program's masks for BiNI (the selection's chain
ends in ``select_chain_pct``, its masks' derivation in
``select_mismatch``).  ``control=True`` puts the reference in the
program's place, one precision down (the NNET with TF32, SAM in float8,
BiNI in bf16), along the same chain, for the numbers that are not exact
replays.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import bini as ref_bini
from .reference import nnet as ref_nnet
from .reference import post as ref_post
from .reference import resize as ref_resize
from .reference import sam as ref_sam
from .reference import select as ref_select

# a log-depth that moved by more than this (0.1%) differs
LOG_TOL = 1e-3
# prompts the reference decodes at once
DECODE_CHUNK = 64


def _rel(got, want) -> float:
    got, want = got.detach().float().to(want.device), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def vit_config(sam: dict):
    return ref_sam.ViTConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                                for k, v in sam.items()})


class Reference:
    """The reference nets on ``device`` from the run's weights (drawn again
    from the configuration's seed); ``control`` makes them the
    one-precision-down control."""

    def __init__(self, config: dict, device, control: bool = False):
        from .inputs import make_weights

        self.device = torch.device(device)
        self.config, self.control = config, control
        sam_sd, nnet_sd = make_weights(config, device)
        self.sam = ref_sam.build_sam(sam_sd, vit_config(config["sam"]), device, quantize=control)
        del sam_sd
        with torch.device("meta"):
            self.nnet = ref_nnet.NNET()
        # the encoder's bn2 feeds only the classifier the NNET does not have
        nnet_sd = {k: v for k, v in nnet_sd.items()
                   if not k.startswith("encoder.original_model.bn2.")}
        self.nnet.load_state_dict(nnet_sd, assign=True, strict=True)
        self.nnet = self.nnet.eval().requires_grad_(False)

    def normals(self, image_u8: np.ndarray) -> torch.Tensor:
        fc = self.config["program"]["frontend"]
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.control
        try:
            n, _ = ref_nnet.predict_normals(
                self.nnet, image_u8, tuple(fc["normals"]["network_dim"]),
                coarse_hw=tuple(fc["normals"]["integration_shape"]))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        return n

    def features(self, image_u8: np.ndarray):
        sam_img = ref_resize.linear_resize(
            image_u8, tuple(self.config["program"]["sam_params"]["infer_resolution"]))
        with torch.no_grad():
            return ref_sam.encode(self.sam, sam_img)

    def decode(self, features, pts):
        with torch.no_grad():
            outs = [ref_sam.decode_points(self.sam, features, pts[lo:lo + DECODE_CHUNK])
                    for lo in range(0, len(pts), DECODE_CHUNK)]
        return torch.cat([m for m, _ in outs]), torch.cat([i for _, i in outs])

    def integrate(self, normals: torch.Tensor, masks: np.ndarray, image_hw, K) -> np.ndarray:
        """BiNI's per-segment depths (M, Hg, Wg), zero outside ``masks``, in
        float32 (bf16 for the control)."""
        fc = self.config["program"]["frontend"]
        Hg, Wg = masks.shape[1:]
        K = np.asarray(K, np.float64).copy()
        K[0] *= Wg / image_hw[1]
        K[1] *= Hg / image_hw[0]
        dtype = torch.bfloat16 if self.control else torch.float32
        zt = ref_bini.integrate(normals.to(dtype), masks,
                                torch.as_tensor(K, dtype=dtype, device=normals.device),
                                fc["cg_max_iter"], fc["cg_tol"])
        return np.where(masks, np.exp(zt), 0.0).astype(np.float32)


def _count_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Elements of ``a`` and ``b`` that differ, or every element of the
    larger where their shapes differ."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size, 1)
    return int(np.count_nonzero(a != b))


def select_chain_pct(got, want, input_hw, config: dict) -> float:
    """% of prompts whose smallest-good pick on the decoder outputs ``got``
    (low-res logits (B, 3, S, S), IoU (B, 3)) differs from that on
    ``want``: kept on one side only, or another candidate."""
    sp = config["program"]["sam_params"]
    args = (input_hw, config["sam"]["img_size"], float(sp["stability_threshold"]),
            float(sp["iou_threshold"]))
    pick_g, valid_g = ref_select.pick_round(*got, *args)
    pick_w, valid_w = ref_select.pick_round(*want, *args)
    differ = (valid_g != valid_w) | (valid_g & valid_w & (pick_g != pick_w))
    return 100.0 * float(differ.float().mean()) if len(differ) else 0.0


def select_number(config: dict, frame: dict, kps1: np.ndarray, input_hw,
                  rng: np.random.Generator, device) -> int:
    """select_mismatch on one frame; advances ``rng`` as the program's
    generator advanced through round 2."""
    cap = frame["capture"]
    fc, sp = config["program"]["frontend"], config["program"]["sam_params"]
    rounds = [(m[:, 1:].to(device).float(), i[:, 1:].to(device).float())
              for m, i in cap["decoder"]]
    sel = ref_select.select_masks(rounds, kps1, fc["num_pts_active"], rng,
                                  sp["infer_resolution"], input_hw, config["sam"]["img_size"], sp)
    got = cap["masks"]
    n = sum(_count_diff(p.cpu().numpy(), w) for p, w in zip(cap["prompts"], sel["prompts"]))
    n += abs(len(cap["prompts"]) - len(sel["prompts"]))
    return (n + _count_diff(got["masks"], sel["masks"])
            + _count_diff(got["keypoints"], sel["keypoints"]))


def program_depths(frame: dict) -> np.ndarray:
    """The program's per-segment depths (M, Hg, Wg), in the order of its
    masks: round 1's composite, then round 2's."""
    return np.concatenate(frame["capture"]["composites"])


def _log_depth_err(got: np.ndarray, want: np.ndarray, masks: np.ndarray) -> float:
    if got.shape != want.shape or (got[masks] <= 0).any():
        return float("inf")
    return float(np.abs(np.log(got[masks]) - np.log(want[masks])).max()) if masks.any() else 0.0


def _dense(regions: np.ndarray, logdepth: np.ndarray):
    """(covered (H, W), overlap-averaged log-depth (H, W)) of a keyframe."""
    n = regions.sum(axis=0)
    s = np.where(regions, np.exp(logdepth), 0.0).sum(axis=0)
    covered = n > 0
    return covered, np.log(np.where(covered, s / np.maximum(n, 1), 1.0))


def differ_pct(got: tuple, want: tuple) -> float:
    """% of the pixels valid on either side of two (valid, log-depth) maps
    that are valid on one side only or differ by more than LOG_TOL."""
    (vg, lg), (vw, lw) = got, want
    differ = (vg != vw) | (vg & vw & (np.abs(lg - lw) > LOG_TOL))
    return 100.0 * float(differ.sum()) / max(int((vg | vw).sum()), 1)


def keyframe_numbers(config: dict, seed: int, frames: dict, device,
                     control: bool = False) -> list[dict]:
    """Each sampled frame's numbers {name: value} for the program, or with
    ``control`` for the control in its place; each row also holds, under
    ``_kf``, the (subject's, reference's) keyframes for the stages after."""
    fc = config["program"]["frontend"]
    ref = Reference(config, device)
    subject = Reference(config, device, control=True) if control else None
    rows = []
    for i in sorted(frames):
        frame = frames[i]
        cap, x, rng = frame["capture"], frame["inputs"], frame["rng"]
        image_hw = x["image"].shape[:2]
        kps1 = x.get("keypoints")
        if kps1 is None:  # the frontend's own round 1 prompts, drawn first
            kps1 = (rng.random((fc["num_pts"], 2)) * 2 - 1).astype(np.float32)
        # the nets, each side on its own outputs
        want_n = ref.normals(x["image"])
        want_f, input_hw = ref.features(x["image"])
        pts = torch.from_numpy(ref_select.input_xy(kps1, input_hw)).to(ref.device)
        want_d = ref.decode(want_f, pts)
        if subject is not None:
            got_n = subject.normals(x["image"])
            got_f = subject.features(x["image"])[0]
            got_d = subject.decode(got_f, pts)
        else:
            got_n = torch.from_numpy(np.asarray(cap["keyframe"]["normals"])).to(ref.device)
            got_f = cap["features"]
            masks, iou = cap["decoder"][0]
            got_d = (masks[:, 1:].to(ref.device).float(), iou[:, 1:].to(ref.device).float())
        row = {"normals_err": float((got_n.float() - want_n).abs().max()),
               "sam_feat_err": _rel(got_f, want_f),
               "decoder_err": (max(_rel(got_d[0], want_d[0]), _rel(got_d[1], want_d[1]))
                               if got_d[0].shape == want_d[0].shape else float("inf")),
               "select_chain_pct": (select_chain_pct(got_d, want_d, input_hw, config)
                                    if got_d[0].shape == want_d[0].shape else 100.0)}
        # BiNI in the program's masks, the reference on its own normals
        Hg, Wg = fc["normals"]["integration_shape"]
        masks = ref_bini.resize_masks(cap["masks"]["masks"], (Hg, Wg))
        want_z = ref.integrate(want_n, masks, image_hw, x["K"])
        got_z = (subject.integrate(got_n, masks, image_hw, x["K"]) if subject is not None
                 else program_depths(frame))
        row["bini_err"] = _log_depth_err(got_z, want_z, masks)
        # the keyframe's last steps, the reference on its own depths (the
        # split's keypoints are not compared, so its generator is its own)
        kps = cap["masks"]["keypoints"]

        def kf(depths):
            return ref_post.keyframe(depths, kps, fc, image_hw, np.random.default_rng(0),
                                    ref.device)

        want_kf = kf(want_z)
        got_kf = kf(got_z) if subject is not None else cap["keyframe"]
        row["kf_chain_pct"] = differ_pct(_dense(got_kf["regions"], got_kf["logdepth_perseg"]),
                                         _dense(want_kf["regions"], want_kf["logdepth_perseg"]))
        if subject is None:
            row["select_mismatch"] = select_number(config, frame, kps1, input_hw, rng, ref.device)
            want = ref_post.keyframe(program_depths(frame), kps, fc, image_hw, rng, ref.device)
            row["kf_mismatch"] = sum(_count_diff(got_kf[k], want[k]) for k in
                                     ("regions", "logdepth_perseg", "keypoints_rc"))
        row["_kf"] = (got_kf, want_kf)
        rows.append(row)
    return rows


def _complete(sparse, kf, device):
    depth, invalid = ref_post.complete(sparse, kf["regions"], kf["logdepth_perseg"],
                                       kf["keypoints_rc"], device)
    return depth, invalid


def _valid_log(depth: np.ndarray, invalid: np.ndarray):
    valid = ~np.asarray(invalid) & (np.asarray(depth) > 0)
    return valid, np.log(np.where(valid, depth, 1.0))


def completion_numbers(frames: dict, rows: list[dict], device, control: bool = False) -> list:
    """``rows`` with depth completion's numbers added: the first pass on
    the reference's own keyframe (and, for the program, replayed on the
    program's keyframe)."""
    for i, row in zip(sorted(frames), rows):
        frame = frames[i]
        sparse = frame["inputs"]["sparse"]
        got_kf, want_kf = row["_kf"]
        want = _complete(sparse, want_kf, device)
        if control:
            got = _complete(sparse, got_kf, device)
        else:
            out = frame["capture"]["output"]
            got = (out["depth"], out["invalid"])
            replay = _complete(sparse, got_kf, device)
            row["completion_mismatch"] = (_count_diff(got[0], replay[0])
                                          + _count_diff(got[1], replay[1]))
        row["completion_chain_pct"] = differ_pct(_valid_log(*got), _valid_log(*want))
    return rows


def worst(rows: list[dict]) -> dict:
    """{number: its largest value over the rows} (keys with ``_`` left out)."""
    out: dict[str, float] = {}
    for row in rows:
        for k, v in row.items():
            if not k.startswith("_"):
                out[k] = max(out.get(k, 0.0), v)
    return out
