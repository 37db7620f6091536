#!/usr/bin/env python
"""Smoke run of the PyTorch port (``super_primitive_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. the card's name and power limit; build the CUDA kernels with nvcc
     (one process per source, all at once); after phase 13 one line gives
     each phase's seconds and the build's;
  2. K1 (``bini_apply``) against its plain PyTorch version at three shapes;
  3. K2 (``bini_cg``) against its plain version at the VO path's crop
     buckets and N (2x32², 34x64², 14x128²), at 8x240x320, and on a q with
     non-zero borders (the ring halo) at 2x32² (one CTA), 3x128² and
     2x240x320 (16 CTAs); each with its cluster plan, the longest
     segment's iterations and µs per iteration;
  3b. K3 (``phase_counts``) against its plain version at (3, 128, 128) and
     at the select rounds' (384 | 96, 256, 256), and on the adversarial
     cases of ``eval/k3_cases.py`` (cutoffs, subnormals, NaN and +-inf,
     Voronoi margins) at 96x256² and 3x128², every count exact;
  3c. the SAM frame's kernel (``sam_frame``: SAM's input frame made from
     the image, both resizes in one pass) against its plain version, every
     byte equal, at the copy, the exact 2x reduction and odd ratios;
  4. BiNI on a 480x640 normal field with 8 masks, which takes the
     K1-per-iteration route, against the plain route;
  5. the two-frame slice: two-frame SfM on the synthetic planes sequence at
     480x640 through the structured fake frontend, which integrates on K2;
  5b. the same problem with ``mapping.solver: gn`` (``solve_two_frame_gn``):
     the scale-aligned pose error cut 3x (two views leave the scale free);
     the solve s beside phase 5's and each level's (initial, final) cost;
  6. at 96x128 the card agrees with the CPU: the frontend's keyframe (also
     with the device SAM selection and the depth split), and the
     photometric cost and its gradients at the solve's init; on the GN
     path, ``gn_track``, ``assemble`` + ``solve_step``, the GN supp
     refinement and ``fused_frame_step`` within ``GN_TOL``, and two
     ``assemble`` calls on the card bit for bit;
  7. the VO slice: ``eval.e2e_synthetic.run_e2e("adam")`` over 9 frames at
     full width on the card (480x640, the device SAM selection on K3, BiNI on K2,
     the depth split), at least 2 keyframes and a Sim(3) ATE below 0.05;
     the share of K3's region pixels that its shortcut leaves to the full
     16-phase path on the path's inputs;
  7b. the GN VO slice: ``run_e2e("gn")`` over 12 frames at full width, at least 2
     keyframes, a Sim(3) ATE below 0.05, K2 and K3 launched, the fused step
     taken and no separate supp mapping, every pose finite; wall s, ms per
     tracked frame, the fused step's split, LM iterations, host reads per
     fused frame beside phase 7's numbers; K2 and K3 against their plain
     versions on the path's inputs phase 7 did not see; one GN track call's
     and one ``assemble``'s device busy time and idle share;
  8. the real nets at full width, on seeded synthetic weights in the
     published names (``nets/synth.py``): SAM ViT-H and the EfficientNet-B5
     NNET, loaded with ``load_state_dict`` into the frontend of
     ``configs/planes_odom.yaml`` (SAM at 240x320 -> a 768x1024 input, 128 +
     32 prompts, the NNET at 480x640; SAM in bf16).  On the SAM weights
     scaled to a trained net's (``synth.scale_like_trained``), in float32
     with TF32 off, the card agrees with the CPU on one windowed and one
     global ViT-H block at 64x64 tokens and the prompt encoder and decoder
     on the card's features for a 32-prompt round, and on the NNET at
     480x640, within ``NET_CARD_TOL``; the bf16 SAM stays within
     ``BF16_TOL`` of the float32 one.  Then two keyframes (cold, warm) and a supporting
     frame, with K3 launched in both rounds of each keyframe, K2 wherever
     a segment exists and the SAM frame's kernel once, and a 4-frame VO run (``run_sfm.run_odometry``)
     through the same frontend; K3 (exact) and K2 on the real decoder's and
     BiNI's recorded inputs, the SAM frame's kernel (exact) on the image
     (480x640 -> 240x320 -> 768x1024); encoder, decode, selection and NNET times;
  9. VOID depth completion at full width on trees in the VOID, TUM and
     Replica layouts written from the planes sequence
     (``eval/dataset_trees.py``; 500 sparse pixels an image): (a) ``python
     -m super_primitive_tpu_torch.evaluate_void --sam-ckpt --nnet-ckpt``
     (its ``main``) with ``configs/void_dataset.yaml`` unchanged over one
     image, on ``.npz`` trees of phase 8's synthetic weights written by
     ``convert.sam_to_flax`` / ``nnet_to_flax``,
     then a second image, on a fifth of its sparse points
     (``VOID_LOOSE_STRIDE``), through ``DepthCompletion(invalid_ratio_thresh=0)``
     so that the loose rerun, and with it K3's statistics path, runs; K2
     and K3 launched, no K1, every K2 field holding a plan; per image the
     wall and the stage split, K3 slabs, peak memory, both metric tables;
     every K2 call logged; K2 against its plain version at the call's own
     max_iter and tol on the first segments and the longest-running ones of
     the path's largest call and of its longest-running call, each call
     timed whole; K3 against its plain version, timed, on the first call at
     each slab count; the SAM frame's kernel against its plain version on
     the path's image (480x640 -> 960x1280 -> 768x1024, every byte), timed,
     with the predictor's whole ``prepare_frame``;
     (b) the structured fake completes the same images, gated on the
     valid-only AbsRel and the validity rate (``VOID_FAKE_*``); (c) the TUM
     and Replica trees decode to the arrays written; ``run_sfm --odom
     --fake-frontend --live-viz`` on the TUM tree (GN solvers, a lower
     keyframe threshold so that three keyframes come) leaves
     ``viewer.html``, ``trajectory.png``, the TUM files and a
     ``live.json`` whose ``seq`` counts the tracked frames, and ``python
     -m super_primitive_tpu_torch.convert_traj_to_tum`` on its run
     directory writes the same TUM files again; two-frame ``run_sfm`` on
     the Replica tree (GN) leaves ``src_pointcloud.ply`` and
     ``viewer.html``; both end finite; a ``tum_undistort`` read; decode
     ms per frame.
  10. the resume slice: ``run_e2e("gn", frames=RESUME_FRAMES,
     restore_split=RESUME_SPLIT, save_every=RESUME_SAVE_EVERY)`` at full
     width: the first leg checkpoints, a fresh ``Odometry`` and frontend
     resume from it and finish the sequence, adding at least one keyframe
     with K2 and K3 launched after the restore (counts reset there); the
     window that ``load_state`` puts on the card equals, bit for bit, the
     one built on the host from the saved keyframes with
     ``build_bundle_np``, and so does the same checkpoint loaded with
     ``device="cpu"``; every pose finite and the Sim(3) ATE over all
     tracked frames below 0.05; ``save_state`` s and bytes, ``load_state``
     s, ms per tracked frame in each leg, keyframes per leg; K2 and K3
     against their plain versions on the second leg's inputs.
  11. the multi-device layouts (``parallel/``): (a) ``dryrun_multichip(1)``
     over NCCL, its six sharded flows on the card; (b) two ranks over gloo,
     both on this card (NCCL takes one rank a card), at full width:
     ``assemble`` and ``gn_mapping`` (5 LM iterations) on phase 7b's window
     recorded at its fullest ``gn_mapping`` call, points over sp = 2, within
     ``SHARD_TOL`` of the unsharded calls; the first VO GN keyframe's BiNI calls at each
     crop bucket, segments over 2 ranks on K2, within 1e-5 (bit-identity
     reported); 128 prompts of phase 8's keyframe through
     ``_decode_select``, decode-only ranks given phase 8's decoder weights
     and encoder features, prompts over 2 ranks on K3, the packed masks,
     picks and K3's counts exact; every rank holding every output bit for
     bit; each flow's sharded and unsharded times (both ranks share the
     card: not a scaling measurement) and each rank's peak memory; K2 and
     K3 launched on every rank and held to their plain versions on the
     ranks' recorded inputs.
  12. slice 10: (a) the prefetching native loader (``data/native_loader``,
     C++ decode threads) on a copy of phase 9c's TUM tree: its PNG RGB and
     16-bit decodes equal ``image_io``'s exactly, the fr1 undistort on its
     decode threads equals ``data/undistort.remap_bilinear`` within 2 (the
     JAX test's interior bound), a gray JPEG written by ``image_io.
     write_jpeg`` decodes near the image written, or, where the build found
     no ``jpeglib.h``, raises naming it; ``image_io``'s decode ms a frame
     beside the loader's wait once warm; ``run_sfm --odom --fake-frontend``
     over the tree with the native loader and with ``image_io``: ms per
     tracked frame and the read wait a frame in each, K2 and K3 launched
     (no gain claimed); (b) ``day0_rehearsal`` on the card: synthetic
     published-name ``.pth`` files -> ``convert_checkpoints --validate`` ->
     ``build_frontend`` -> ``evaluate_void`` -> ``run_sfm --odom`` through
     the native loader, ATE below 0.05; (c) on phase 8's ViT-H features and
     bf16 decoder, ``predict_points_with_stats`` and the selection at
     out_size 512 (S = 256): K3 launched and exact against its plain
     version; on the same low-res logits, the card's statistics and
     selection against the CPU's: logits after the resize within
     ``FULLRES_TOL`` of the largest, masks exact except where |logit| is
     below that, K3's counts, picks and validity exact;
     ``predict_batched_points`` on 64 prompts with phase 8's float32
     decoder, card against CPU within ``NET_CARD_TOL["decoder"]``; (d)
     ``photometric_cost`` in each normal mode, card against CPU within
     ``MODE_TOL`` relative; (e) the full-size day-0 leg
     (``day0_rehearsal.full_size_leg``) in a process of its own, whose
     host RSS holds only the leg: a ViT-H-sized synthetic
     ``sam_vit_h_4b8939.pth`` (2.56 GB, published names) ->
     ``convert_checkpoints --validate`` at the default ``vit_h`` on the card
     -> step 2 on the converted tree, K3 launched on it and exact against
     its plain version; the ``.npz`` equal, bit for bit, to
     ``convert.sam_to_flax`` of the same synthetic state dict (the tree
     phases 8 and 9 run); the files' bytes, the write, convert and validate
     s, peak host RSS and device memory, and the float32 ViT-H forward on
     the converted tree, warm;
  13. the SAM encoder's attention lowerings and K4 (``ext_attention``) at
     ViT-H on phase 8's weights at a trained net's scale: the two bf16
     encoders the path's predictors build (the default's windowed and
     global "ext", persistent windows and tanh GELU; the "flash"
     predictor's, which keeps its caller's config), bf16 global "xla" and
     "flash" with the default's windows, and the materialised-bias "xla"
     with per-block partitions, each within ``BF16_TOL["features"]`` of
     the float32 "xla" encoder, and the float32 "flash" encoder within
     ``FLASH_F32_TOL`` of it; K4 launched 4 times a "flash" encode and
     never otherwise; each encoder's ms, busy ms, kernels and peak memory;
     a real-net keyframe through the bf16 "flash" predictor (K4 and K3
     launched, finite) beside the default keyframe; K4 on the inputs that
     keyframe and the float32 "flash" encoder gave it and at a ragged and
     the tiny config's shape, in float32 within ``K4_F64_TOL`` of the
     plain version's distance from float64 and in bf16 within
     ``K4_BF16_TOL`` of the plain version, with the plain version's,
     ``F.scaled_dot_product_attention``'s (timed here only) and the
     bound's times (bf16 at the tensor cores' 989 TFLOP/s, float32 at a
     third of their 494.7 TFLOP/s TF32 rate: the float32 body runs three
     TF32 products for each) and each one's peak memory; each row names
     its dtype's body (``K4_BODIES``) and its TFLOP/s and share of the
     bound and the HGMMA / HMMA count of the function it ran, the K4 line
     that of the whole library's SASS (``cuobjdump -sass``; none, or none
     in a row's function, fails the run).

Launch counts (every kernel's, ``reset_launch_counts``) are reset just
before the paths of phases 4, 5, 5b, 7, 7b, 8, 9, 10 (at its restore), 11b
(in each rank), 12a-c, 12e (in its process) and 13c and read just after; a
kernel of a path that was not launched there fails the run, and so does K4
launched on any path before phase 13.
Those paths also keep a copy of each kernel's inputs at every shape they
give it (phase 9 keeps K2's largest and longest-running calls whole), and
after the path each kernel is checked and timed on them.
It prints one ``{"kernels": [...]}`` line with each kernel's error, times
and bound on those inputs (summed over the shapes), the nvidia-smi line,
and last ``{"ok": true, "device": ...}``.  K1's and K3's rows carry
``device_ms`` beside the event time: the kernels' own device time (K3's
with the memset of its counts) from torch.profiler's CUDA activity, which
the host's launch rate does not bound, on copies of the inputs that do not
fit the L2 cache; and ``graph_ms``, the replay of a CUDA graph of the same
calls (``device_timer`` says ``events`` where CUPTI delivered no record of
a session and CUDA events around each call took the profiler's place).
The script fails if the two disagree by more than 5 us + 5% in six
measurements in a row, or if either kernel's device time is below its
bound.
It exits non-zero without a result where there is no CUDA device, and in a
directory that does not hold the package beside it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 (non-tensor-
# core) flop/s, the type K1-K3 compute in, the dense bf16 tensor-core rate,
# the peak for K4's bf16 inputs, and a third of the dense TF32 rate, the
# peak for K4's float32 inputs (each product is three TF32 products, 3xTF32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32X3_FLOP_PER_S = 494.7e12 / 3
# its L2 cache (50 MB): device times cycle through copies of the inputs
# that together hold three times this, so every call reads from HBM
L2_BYTES = 50 * 2**20
# flops per pixel: the stencil of _apply_math (8 + 7) plus <p, Ap> (2) for
# K1; for one K2 CG iteration the masked stencil (16), three masked dots
# (9), the x, r and p updates (6) and the preconditioner (2).  K3's bound
# has no operation term: its shortcut settles most pixels from their 3x3
# window's range, exactly, so the reference's 16 interpolants a pixel are
# no floor on the work an exact kernel must do; the bytes are.
K1_FLOPS_PER_PIXEL = 17
K2_FLOPS_PER_PIXEL_ITER = 33
# the VO slices' frames: GN's 12 (it made 2 keyframes there); Adam's 9,
# cut from 12 for the script's time (the sequence moves 0.0244 a frame
# against the 0.08 keyframe threshold: keyframes at frames 3 and 7 of 0-8,
# where 12 frames made a third at 11)
VO_FRAMES = 12
ADAM_VO_FRAMES = 9
# phase 3's K2 shapes: the VO path's largest call at each crop bucket (its
# first keyframe, round 1) and the full 240x320 integration field
K2_CHECK_SHAPES = [(2, 32, 32), (34, 64, 64), (14, 128, 128), (8, 240, 320)]
# the ring-halo shapes: one CTA, 8 CTAs and 16 CTAs a segment
K2_RING_SHAPES = [(2, 32, 32), (3, 128, 128), (2, 240, 320)]
# phase 3c's SAM frame shapes (image, infer_resolution, SAM's input): the
# copy, the exact 2x reduction and odd ratios; the keyframe's own shapes
# come from phases 8 and 9
SAM_FRAME_CHECK_SHAPES = [((48, 64), (48, 64), (48, 64)), ((96, 128), (48, 64), (24, 32)),
                          ((97, 131), (200, 260), (150, 197)),
                          ((300, 400), (150, 200), (77, 103)), ((60, 80), (60, 100), (51, 85))]
REAL_NET_FRAMES = 4
# phase 8, card against CPU in float32: relative to max|CPU| for the ViT-H
# blocks and the decoder's logits and IoU, on the synthetic SAM weights at
# a trained net's scale (``synth.scale_like_trained``; the std-1 weights
# saturate the softmax, where two summation orders part by ~1e-4), and
# absolute for the NNET's unit normals and kappa.  An H100 read 3.1e-6
# (block 0), 1.2e-6 (block 7), 9.1e-7 / 1.0e-6 (decoder logits / IoU) and
# 3.0e-7 (NNET); the decoder's limit is the JAX oracle's 4.0e-6.
NET_CARD_TOL = {"block": 1e-5, "decoder": 4e-6, "nnet": 1e-5}
# bf16 SAM against float32 on the same scaled weights, relative to the
# float32 run's largest magnitude: about twice an H100's readings of
# 2.5e-2 (features), 2.8e-2 (logits) and 1.2e-2 (IoU)
BF16_TOL = {"features": 5e-2, "logits": 6e-2, "iou": 3e-2}
# phase 9: VOID500 density (500 sparse pixels an image, drawn from the
# seed; VOID publishes 150, 500 and 1500), one image through evaluate_void
# and a second through the forced loose rerun; TUM and Replica trees of 10
# and 5 frames.  Cut for the script's time: at VOID1500 the evaluate_void
# image's loose pass took 70.6 s over 7,297 segments, its host work growing
# with the segments the sparse points give (the structured fake read
# AbsRel 0.0397, validity 0.997 at 500 on an H100; 0.0382, 1.0 at 1500)
VOID_IMAGES, VOID_SPARSE, VOID_SEED = 1, 500, 9
# the forced loose rerun's image keeps every VOID_LOOSE_STRIDE-th of its
# sparse points (100 of 500), for the same reason
VOID_LOOSE_STRIDE = 5
TUM_FRAMES, REPLICA_FRAMES = 10, 5
# phase 9c's TUM odometry run must make the three ground-truth keyframes
# that trajectory.png needs: planes_odom.yaml's keyframe translation
# threshold (0.08) halved
TUM_KF_TRANSLATION = 0.04
# phase 10: the GN VO run split at a frame and resumed from its checkpoint
RESUME_FRAMES, RESUME_SPLIT, RESUME_SAVE_EVERY = 24, 12, 4
# phase 11b's bounds, sharded against unsharded on the card: the JAX
# package's own (tests/test_multichip.py); BiNI's segments solve alone, so
# the bound there is 1e-5 and bit-identity is reported
SHARD_TOL = {"H": 2e-4, "assemble": 1e-5, "assemble_rel": 1e-5, "gn_pose": 1e-3,
             "gn_cost_rel": 1e-3, "bini": 1e-5, "decode": 1e-4}
# phase 10's window fields, held bit for bit after load_state
RESUME_WINDOW_FIELDS = ("images", "K", "poses", "kp_logdepth", "affine", "kf_valid", "uv",
                        "seg_id", "base_logdepth", "point_valid", "num_valid", "kp_base")
# phase 9b's bounds on the structured fake (exact plane normals, median
# alignment to the sparse ground truth), written before its first chip run
# from CPU rehearsals at 120x160 (valid-only AbsRel 0.041-0.056, validity
# 0.93) and 240x320 (0.038-0.044, 0.99)
VOID_FAKE_ABSREL, VOID_FAKE_VALIDITY = 0.06, 0.90
# phase 12c: the SAM selection's grid at an out_size other than the
# low-res S = 256, and the bound of its resized logits, card against CPU on
# the same low-res logits, relative to the largest (float32 resize weights
# contracted by cuBLAS and by the CPU in their own orders: a few ulps)
FULLRES_OUT, FULLRES_TOL = 512, 1e-5
# phase 12d: photometric_cost in each normal mode, card against CPU
MODE_TOL = 1e-5
# phase 13: K4 in float32 against the float64 function, relative to its
# max: within K4_F64_TOL = (factor, floor) of the plain version's distance,
# factor x plain + floor (at ViT-H's shape each is about 1.8e-5 from
# float64; a kernel that rounds to bf16 inside lands near 2e-3); in bf16
# against the plain version, relative to max|plain|: 8e-3, two bf16
# roundings (the kernel's output and the plain version's, both float32
# inside)
K4_F64_TOL = (2.0, 1e-6)
K4_BF16_TOL = 8e-3
# K4's body for each dtype, both on the tensor cores: wgmma on bf16 for
# bf16, wgmma on 3xTF32 split products for float32 (one TF32 product would
# miss K4_F64_TOL)
K4_BODIES = {"bfloat16": "wgmma", "float32": "wgmma_3xtf32"}
# and each body's kernels, as torch.profiler names them: float32's pre-pass
# (K's and V^T's TF32 halves) and main kernel
K4_KERNEL_NAMES = {"bfloat16": ("ext_attention_tc",),
                   "float32": ("x3::split_k", "x3::split_v", "ext_attention_x3")}
# the function each body's SASS is counted in, for ceil(D_v / 16) value blocks
K4_SASS_FUNCTIONS = {"wgmma": "ext_attention_tcILi{}E", "wgmma_3xtf32": "ext_attention_x3ILi{}E"}
# the float32 "flash" encoder against the float32 "xla" one, relative to
# the latter's largest feature
FLASH_F32_TOL = 1e-4
# K4's check shapes beside the path's: a ragged L (not a multiple of the
# kernel's 64-query tile) and the tiny config's (a 4x6 token grid, 2 heads
# of 16: D_qk 16 + 4 + 6)
K4_RAGGED = (3, 1000, 208, 80)
K4_TINY = (2, 24, 26, 16)
# phase 9's K2 check on a recorded call: its first segments and the ones
# that ran the most iterations, this many of each, against the plain
# version, which solves one segment at a time (2000 iterations took 17.3 s
# for 15 segments at 240x320: cut from 8 for the script's time)
K2_VOID_SLICE = 4


def reset_launch_counts():
    """Set every kernel's launch count to 0: K1 and K2 (``ops.stencil``),
    K3 (``ops.phase_counts``), K4 (``ops.attention``), the SAM frame's
    (``ops.sam_frame``)."""
    from super_primitive_tpu_torch.ops import attention, phase_counts, sam_frame, stencil

    for module in (stencil, phase_counts, attention, sam_frame):
        module.reset_launch_counts()


def launch_counts() -> dict:
    """{kernel: launches since the last :func:`reset_launch_counts`}."""
    from super_primitive_tpu_torch.ops import attention, phase_counts, sam_frame, stencil

    return {**stencil.launch_counts, **phase_counts.launch_counts, **attention.launch_counts,
            **sam_frame.launch_counts}


def fail(msg: str):
    raise RuntimeError(msg)


def bound_ms(nbytes: float, flops: float,
             flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """CUDA-event time of ``reps`` back-to-back calls, over the count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def profiled_ms(torch, fn, calls, names: tuple[str, ...]) -> tuple[float | None, dict]:
    """Device time of one call from torch.profiler's CUDA activity over
    ``calls``: for each of ``names`` (kernels, and a memset the wrapper
    issues; each runs once a call) the median duration of its records,
    since CUPTI, kept up between sessions (see main), may deliver only part
    of a session's records, and one record stretched by the profiler's own
    work must not move the time.  Returns (ms, records seen per name), ms
    None when a name has no record (CUPTI delivered none of them); fails if
    a name was seen more often than the calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in calls:
            fn(*a)
        torch.cuda.synchronize()
    seen = {name: [] for name in names}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            for name in names:
                if name in ev.name:
                    seen[name].append(ev.time_range.elapsed_us())
    counts = {name: len(us) for name, us in seen.items()}
    if any(n > len(calls) for n in counts.values()):
        fail(f"torch.profiler saw {counts} records in {len(calls)} calls")
    if not all(counts.values()):
        return None, counts
    return sum(statistics.median(us) for us in seen.values()) / 1e3, counts


def evented_ms(torch, fn, calls) -> float:
    """Device time of one call from a pair of CUDA events around each of
    ``calls`` (the median), for a session in which CUPTI delivered no
    record."""
    pairs = []
    for a in calls:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(*a)
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def replayed_ms(torch, graph, n_calls: int) -> float:
    """Device time of one call from the fastest of three replays of a CUDA
    graph of ``n_calls`` calls (it adds the gaps between launches)."""
    times = []
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n_calls)
    return min(times)


# device_ms measures this many times before it gives up on agreement
TIMING_ATTEMPTS = 6


def device_ms(torch, fn, args, names: tuple[str, ...], min_calls: int = 20):
    """(device ms, graph ms, timer, attempts): the device time of one
    ``fn(*args)`` with its inputs in HBM, not in L2, by ``profiled_ms`` (or
    ``evented_ms`` where the profiler delivered no record of a name; timer
    says which) and ``replayed_ms`` over the same calls, which cycle
    through copies of ``args`` that together hold 3x the L2 cache.  Where
    the two differ by more than 5 us + 5% (a clock excursion during one of
    them), both are measured again; fails if that happens
    ``TIMING_ATTEMPTS`` times."""
    nbytes = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    copies = max(2, -(-3 * L2_BYTES // nbytes))
    sets = [[a.clone() if torch.is_tensor(a) else a for a in args] for _ in range(copies)]
    calls = [sets[k % copies] for k in range(max(min_calls, copies))]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in calls:
            fn(*a)
    graph.replay()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(1, TIMING_ATTEMPTS + 1):
        dev_ms, counts = profiled_ms(torch, fn, calls, names)
        timer = "profiler"
        if dev_ms is None:
            dev_ms, timer = evented_ms(torch, fn, calls), "events"
        graph_ms = replayed_ms(torch, graph, len(calls))
        seen.append(f"{timer} {dev_ms * 1e3:.2f} us ({counts} profiler records in "
                    f"{len(calls)} calls), graph replay {graph_ms * 1e3:.2f} us")
        if abs(graph_ms - dev_ms) <= 5e-3 + 0.05 * graph_ms:
            return dev_ms, graph_ms, timer, attempt
    fail(f"device times of {names} disagree: " + "; ".join(seen))


def host_ms(torch, fn) -> float:
    """Host-clock time of one call that ends in a synchronise (the plain
    CG, whose loop reads its stop test on the host)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def first_inputs(torch, stencil, name: str):
    """While open, ``stencil.<name>`` keeps a copy of the arguments of its
    first call at each field shape whose first field is not all zero (the
    first K1 call of a CG applies A to x0 = 0).  Yields {shape: args}."""
    seen = {}
    wrapped = getattr(stencil, name)

    def spy(*args):
        shape = tuple(args[0].shape)
        if shape not in seen and bool(args[0].any()):
            seen[shape] = [a.clone() if torch.is_tensor(a) else a for a in args]
        return wrapped(*args)

    setattr(stencil, name, spy)
    try:
        yield seen
    finally:
        setattr(stencil, name, wrapped)


@contextlib.contextmanager
def kept_calls(module, name: str, keep):
    """While open, ``module.<name>`` hands each call's (args, kwargs) to
    ``keep`` before it runs."""
    wrapped = getattr(module, name)

    def spy(*args, **kwargs):
        keep(args, kwargs)
        return wrapped(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, wrapped)


def keep_fullest_gn(rec: dict):
    """A :func:`kept_calls` hook for ``gn_mapping``: a copy of the last call
    over the most keyframes, as flow arguments (``parallel/dryrun.py``)."""
    from super_primitive_tpu_torch.odometry.mapper import MapMasks, MapSlots
    from super_primitive_tpu_torch.parallel.dryrun import window_to

    def keep(args, kw):
        b = args[0]
        kfs = int((b.num_valid > 0).sum())
        if kfs >= rec.get("keyframes", 0):
            rec.update(keyframes=kfs, buffers=window_to(b, b.images.device),
                       slots=MapSlots(*(a.copy() for a in args[1:4])),
                       masks=MapMasks(*(a.copy() for a in args[4:7])), geo_dims=args[7],
                       options=dict(kw))
    return keep


def keep_first_bini(rec: dict):
    """A :func:`kept_calls` hook for ``integrate_normals_cropped``: a copy of
    the first call at each crop, as flow arguments."""
    def keep(args, kw):
        crop = args[4] if len(args) > 4 else kw["crop"]
        if crop not in rec:
            rec[crop] = dict(normals=args[0].clone(), masks=args[1].clone(), K=args[2].clone(),
                             config=args[3], crop=crop,
                             return_crops=kw.get("return_crops", False))
    return keep


def host_copy(x):
    """``x`` with every tensor and window buffer moved to the host."""
    from super_primitive_tpu_torch.odometry.window import WindowBuffers
    from super_primitive_tpu_torch.parallel.dryrun import window_to

    if isinstance(x, WindowBuffers):
        return window_to(x, "cpu")
    if isinstance(x, dict):
        return {k: host_copy(v) for k, v in x.items()}
    return x.cpu() if hasattr(x, "cpu") and hasattr(x, "is_cuda") else x


def bini_fields(torch, bini, N, H, W, seed):
    """BiNI-shaped inputs: q, b and diag from ``_system`` on random masks
    and unit normals, and a random masked p."""
    g = torch.Generator().manual_seed(seed)
    masks = torch.rand(N, H, W, generator=g) > 0.3
    normals = torch.randn(H, W, 3, generator=g)
    normals[..., 2] = -normals[..., 2].abs() - 1.0
    normals = normals / normals.norm(dim=-1, keepdim=True)
    K = torch.tensor([[1.08 * W, 0.0, W / 2], [0.0, 1.08 * W, H / 2], [0.0, 0.0, 1.0]])
    D, c_u, c_v = bini._coefficients(normals, K)
    em = {k: v.float() for k, v in bini._edge_masks(masks).items()}
    w_u = torch.rand(N, H, W, generator=g)
    w_v = torch.rand(N, H, W, generator=g)
    q, b, diag = bini._system(D, c_u, c_v, em, w_u, w_v)
    qs = [q[k].expand(N, H, W).contiguous().cuda() for k in ("up", "um", "vp", "vm")]
    p = (torch.randn(N, H, W, generator=g) * masks).cuda()
    maskf = masks.float().cuda()
    b = (b * masks).expand(N, H, W).contiguous().cuda()
    diag = diag.expand(N, H, W).contiguous().cuda()
    return qs, p, maskf, b, diag


def k1_row(torch, stencil, p, *qs) -> dict:
    """K1 against bini_apply_reference on one input: Ap and the dots within
    relative 1e-5; kernel and plain times; the bound (5 fields read, Ap and
    the dots written; 17 flops a pixel)."""
    N, H, W = p.shape
    ap_k, dots_k = stencil.bini_apply(p, *qs)
    ap_r, dots_r = stencil.bini_apply_reference(p, *qs)
    err_ap = float((ap_k - ap_r).abs().max() / ap_r.abs().max().clamp(min=1e-30))
    err_dot = float(((dots_k - dots_r).abs() / dots_r.abs().clamp(min=1e-30)).max())
    ms = time_ms(torch, lambda: stencil.bini_apply(p, *qs), reps=100)
    dev_ms, graph_ms, timer, attempts = device_ms(torch, stencil.bini_apply, (p, *qs),
                                                  ("bini_apply_kernel", "sum_partials_kernel"))
    plain_ms = time_ms(torch, lambda: stencil.bini_apply_reference(p, *qs), reps=20)
    nbytes, flops = (6 * N * H * W + N) * 4, K1_FLOPS_PER_PIXEL * N * H * W
    b_ms, b_by = bound_ms(nbytes, flops)
    print(f"K1 {N}x{H}x{W}: rel err Ap {err_ap:.2e} dot {err_dot:.2e}; "
          f"kernel {ms * 1e3:.1f} us (device {dev_ms * 1e3:.2f} us, graph "
          f"{graph_ms * 1e3:.2f} us), plain {plain_ms * 1e3:.1f} us, bound "
          f"{b_ms * 1e3:.2f} us ({b_by})", flush=True)
    if not (err_ap <= 1e-5 and err_dot <= 1e-5):
        fail(f"K1 disagrees with its plain version at {N}x{H}x{W}")
    if dev_ms < b_ms:
        fail(f"K1's device time at {N}x{H}x{W} is below its bound")
    return {"shape": [N, H, W], "max_abs_err": float((ap_k - ap_r).abs().max()),
            "rel_err_ap": err_ap, "rel_err_dot": err_dot, "ms": ms,
            "device_ms": dev_ms, "graph_ms": graph_ms, "device_timer": timer,
            "timing_attempts": attempts, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops}


def masked_residual(torch, stencil, x, b, maskf, qs):
    ap, _ = stencil.bini_apply_reference(x, *qs)
    return torch.sqrt(torch.sum(((b - ap * maskf) * maskf) ** 2, dim=(-2, -1)))


def ring_fields(torch, N, H, W, seed):
    """K2 inputs whose q is positive everywhere, borders included, so the
    stencil's wrap-around terms count (row 0's upper neighbour is row H-1,
    held by the last CTA of a cluster); diag is A's diagonal."""
    g = torch.Generator().manual_seed(seed)
    qs = [torch.rand(N, H, W, generator=g) + 0.1 for _ in range(4)]
    up, um, vp, vm = qs

    def roll(x, dr, dc):
        return torch.roll(x, (dr, dc), dims=(-2, -1))

    diag = (up + roll(up, 0, 1) + um + roll(um, 0, -1)
            + vp + roll(vp, 1, 0) + vm + roll(vm, -1, 0))
    maskf = (torch.rand(N, H, W, generator=g) > 0.2).float()
    b = torch.randn(N, H, W, generator=g) * maskf
    x0 = 0.01 * torch.randn(N, H, W, generator=g) * maskf
    return [t.contiguous().cuda() for t in (b, x0, maskf, diag, *qs)]


def k2_row(torch, stencil, b, x0, maskf, diag, *rest, label="") -> dict:
    """K2 against bini_cg_reference on one input: the solution within
    1e-4 * max|x| and each segment's residual within 1.5x of the plain one;
    kernel and plain times; the bound (8 fields read, x written; 33 flops a
    pixel for each CG iteration these inputs take)."""
    qs, (max_iter, tol) = rest[:4], rest[4:]
    args = (b, x0, maskf, diag, *qs, max_iter, tol)
    N, H, W = b.shape
    plan = stencil.cg_plan(H, W)
    x_k, it_k = stencil.bini_cg(*args)
    x_r, it_r = stencil.bini_cg_reference(*args)
    err = float((x_k - x_r).abs().max())
    scale = float(x_r.abs().max())
    res_k = masked_residual(torch, stencil, x_k, b, maskf, qs)
    res_r = masked_residual(torch, stencil, x_r, b, maskf, qs)
    res_ratio = float((res_k / res_r.clamp(min=1e-30)).max())
    ms = time_ms(torch, lambda: stencil.bini_cg(*args), reps=5)
    plain_ms = host_ms(torch, lambda: stencil.bini_cg_reference(*args))
    iters, max_it = int(it_k.sum()), int(it_k.max())
    same = [bool(torch.equal(a, c)) for a, c in zip(x_k, x_r)]
    iters_agree = all(int(i) == int(j) for i, j, s in zip(it_k, it_r, same) if s)
    us_per_iter = ms * 1e3 / max(max_it, 1)
    nbytes, flops = 9 * N * H * W * 4, K2_FLOPS_PER_PIXEL_ITER * iters * H * W
    b_ms, b_by = bound_ms(nbytes, flops)
    print(f"K2 {N}x{H}x{W}{' ' + label if label else ''} plan (cluster, threads, smem) "
          f"{tuple(plan)}: max abs err {err:.2e} (max|x| {scale:.2e}), residual ratio "
          f"{res_ratio:.3f}, iters {iters} (plain {int(it_r.sum())}), longest segment "
          f"{max_it}; kernel {ms:.3f} ms ({us_per_iter:.2f} us per iteration), plain "
          f"{plain_ms:.1f} ms, bound {b_ms * 1e3:.1f} us ({b_by})", flush=True)
    if not (err <= 1e-4 * scale and res_ratio <= 1.5 and iters_agree):
        fail(f"K2 disagrees with its plain version at {N}x{H}x{W} {label}")
    return {"shape": [N, H, W], "plan": list(plan), "max_abs_err": err, "max_abs_x": scale,
            "residual_ratio": res_ratio, "iters": iters, "plain_iters": int(it_r.sum()),
            "max_iters": max_it, "us_per_iter": us_per_iter, "exact_segments": sum(same),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops, **({"case": label} if label else {})}


@contextlib.contextmanager
def k2_calls(torch, stencil):
    """While open, every ``stencil.bini_cg`` call is logged (field shape,
    max_iter, tol, iterations summed and the longest segment's), and host
    copies are kept of the call with the most segments and of the call
    whose longest segment ran the most iterations (the first of each; one
    copy where they are one call).  Yields {"log": [...], "kept": [(label,
    args), ...]}, ``kept`` filled when the block ends."""
    seen = {"log": [], "kept": []}
    best = {"most segments": (-1, None), "most iterations": (-1, None)}
    copies = {}
    wrapped = stencil.bini_cg

    def spy(*args):
        x, it = wrapped(*args)
        call = len(seen["log"])
        N, H, W = args[0].shape
        longest = int(it.max()) if N else 0
        seen["log"].append({"shape": [N, H, W], "max_iter": int(args[8]),
                            "tol": float(args[9]), "iters": int(it.sum()),
                            "longest": longest})
        for label, score in (("most segments", N), ("most iterations", longest)):
            if score > best[label][0]:
                best[label] = (score, call)
                if call not in copies:
                    copies[call] = [a.cpu() if torch.is_tensor(a) else a for a in args]
        for c in list(copies):
            if all(c != b[1] for b in best.values()):
                del copies[c]
        return x, it

    stencil.bini_cg = spy
    try:
        yield seen
    finally:
        stencil.bini_cg = wrapped
        by_call = {}
        for label, (_, call) in best.items():
            if call is not None:
                by_call.setdefault(call, []).append(label)
        seen["kept"] = [(" and ".join(labels), copies[c]) for c, labels in sorted(by_call.items())]


def k2_void_row(torch, stencil, args, label: str) -> dict:
    """K2 on one whole recorded call of the VOID path, on the card: the call
    timed; its first ``K2_VOID_SLICE`` segments and the ``K2_VOID_SLICE``
    that ran the most iterations against the plain version at the call's
    own max_iter and tol (solution within 1e-4 x max|x|, each residual
    within 1.5x of the plain one, equal iterations where the solutions are
    equal), the plain version timed on those segments (``plain_segments``).
    The bound is the whole call's: 8 fields read, x written, 33 flops a
    pixel for each iteration it ran."""
    args = [a.cuda() if torch.is_tensor(a) else a for a in args]
    b, x0, maskf, diag, *qs = args[:8]
    max_iter, tol = args[8:]
    N, H, W = b.shape
    plan = stencil.cg_plan(H, W)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    x_k, it_k = stencil.bini_cg(*args)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)  # the call took seconds: once is enough
    most = it_k.argsort(descending=True)[:K2_VOID_SLICE].tolist()
    idx = sorted(set(range(min(K2_VOID_SLICE, N))) | set(most))
    sel = torch.tensor(idx, device=b.device)
    part = [a.index_select(0, sel).contiguous() if torch.is_tensor(a) else a for a in args]
    got, its = x_k.index_select(0, sel), it_k.index_select(0, sel)
    plain = []
    plain_ms = host_ms(torch, lambda: plain.append(stencil.bini_cg_reference(*part)))
    x_r, it_r = plain[0]
    err = float((got - x_r).abs().max())
    scale = float(x_r.abs().max())
    res_k = masked_residual(torch, stencil, got, part[0], part[2], part[4:8])
    res_r = masked_residual(torch, stencil, x_r, part[0], part[2], part[4:8])
    res_ratio = float((res_k / res_r.clamp(min=1e-30)).max())
    same = [bool(torch.equal(a, c)) for a, c in zip(got, x_r)]
    iters_agree = all(int(i) == int(j) for i, j, sm in zip(its, it_r, same) if sm)
    iters, max_it = int(it_k.sum()), int(it_k.max())
    nbytes, flops = 9 * N * H * W * 4, K2_FLOPS_PER_PIXEL_ITER * iters * H * W
    b_ms, b_by = bound_ms(nbytes, flops)
    print(f"K2 {N}x{H}x{W} VOID, {label}, max_iter {max_iter} tol {tol:g}, plan (cluster, "
          f"threads, smem) {tuple(plan)}: {len(idx)} segments checked (iterations "
          f"{[int(i) for i in its]}, plain {[int(i) for i in it_r]}): max abs err {err:.2e} "
          f"(max|x| {scale:.2e}), residual ratio {res_ratio:.3f}; whole call {iters} "
          f"iterations, longest segment {max_it}, kernel {ms:.3f} ms; plain {plain_ms:.1f} ms "
          f"on the {len(idx)} segments; bound {b_ms * 1e3:.1f} us ({b_by})", flush=True)
    if not (err <= 1e-4 * scale and res_ratio <= 1.5 and iters_agree):
        fail(f"K2 disagrees with its plain version on the VOID call {N}x{H}x{W} ({label})")
    return {"shape": [N, H, W], "call": label, "max_iter": max_iter, "tol": tol,
            "plan": list(plan), "checked_segments": idx, "max_abs_err": err,
            "max_abs_x": scale, "residual_ratio": res_ratio,
            "checked_iters": [int(i) for i in its], "plain_iters": [int(i) for i in it_r],
            "exact_segments": sum(same), "iters": iters, "max_iters": max_it, "ms": ms,
            "plain_ms": plain_ms, "plain_segments": len(idx), "bound_ms": b_ms,
            "bound_by": b_by, "bytes": nbytes, "flops": flops}


def check_k1(torch, bini, stencil):
    """Phase 2: K1 against its plain version on random BiNI-shaped fields."""
    rows = []
    for N, H, W in [(32, 32, 32), (8, 240, 320), (4, 480, 640)]:
        qs, p, *_ = bini_fields(torch, bini, N, H, W, seed=H + N)
        rows.append(k1_row(torch, stencil, p, *qs))
    return rows


def check_k2(torch, bini, stencil):
    """Phase 3: K2 against its plain version (max_iter 1000, tol 1e-3) at
    the VO path's crop buckets, the full field and the ring-halo case."""
    rows = []
    for N, H, W in K2_CHECK_SHAPES:
        qs, p, maskf, b, diag = bini_fields(torch, bini, N, H, W, seed=7 * H + N)
        x0 = 0.01 * p  # a warm start, as BiNI's outer iterations give K2
        rows.append(k2_row(torch, stencil, b, x0, maskf, diag, *qs, 1000, 1e-3))
    for N, H, W in K2_RING_SHAPES:
        rows.append(k2_row(torch, stencil, *ring_fields(torch, N, H, W, seed=11), 1000, 1e-3,
                           label="ring q"))
    return rows


def upsample_counts(torch, x, s, input_hw):
    """The library route to K3's statistics: PyTorch's bilinear x s
    upsample, cropped to the region, and the three masked counts."""
    import torch.nn.functional as F

    up = F.interpolate(x[:, None], scale_factor=s, mode="bilinear", align_corners=False)[:, 0]
    up = up[:, : input_hw[0], : input_hw[1]]
    return tuple(torch.sum(up > t, dim=(1, 2), dtype=torch.int32) for t in (1.0, -1.0, 0.0))


def k3_bytes(N, S, s, input_hw) -> int:
    """The bytes an exact K3 must move: the region's low-res rows and the
    clamped neighbour row below them, read once, and three counts a slab."""
    R = min(-(-input_hw[0] // s) + 1, S)
    return (N * R * S + 3 * N) * 4


def k3_row(torch, k3, x, s, input_hw) -> dict:
    """K3 against phase_counts_reference on one input, every count exact;
    kernel (events and device), plain and library (upsample + counts) times;
    the bound (bytes only, see K1_FLOPS_PER_PIXEL).  The library route's
    count difference is printed, not held: it interpolates in its own
    order."""
    N, S, _ = x.shape
    got = k3.phase_counts(x, s, input_hw)
    want = k3.phase_counts_reference(x, s, input_hw)
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    lib_err = max(int((g - w).abs().max()) for g, w in zip(got, upsample_counts(torch, x, s, input_hw)))
    ms = time_ms(torch, lambda: k3.phase_counts(x, s, input_hw), reps=50)
    dev_ms, graph_ms, timer, attempts = device_ms(
        torch, lambda x_: k3.phase_counts(x_, s, input_hw), (x,), ("phase_counts_kernel", "Memset"))
    plain_ms = time_ms(torch, lambda: k3.phase_counts_reference(x, s, input_hw), reps=3)
    library_ms = time_ms(torch, lambda: upsample_counts(torch, x, s, input_hw), reps=5)
    nbytes = k3_bytes(N, S, s, input_hw)
    b_ms, b_by = bound_ms(nbytes, 0)
    print(f"K3 {N}x{S}x{S} s={s} hw={tuple(input_hw)} plan {k3.launch_plan(N, S, s, input_hw)}: "
          f"max abs err {err} (library route {lib_err}); kernel {ms * 1e3:.1f} us (device "
          f"{dev_ms * 1e3:.2f} us, graph {graph_ms * 1e3:.2f} us), plain {plain_ms:.3f} ms, "
          f"library {library_ms:.3f} ms, bound {b_ms * 1e3:.2f} us ({b_by})", flush=True)
    if err != 0:
        fail(f"K3 disagrees with its plain version at {N}x{S}x{S}")
    if dev_ms < b_ms:
        fail(f"K3's device time at {N}x{S}x{S} is below its bound")
    return {"shape": [N, S, S], "input_hw": list(input_hw), "max_abs_err": err,
            "library_count_diff": lib_err, "ms": ms, "device_ms": dev_ms,
            "graph_ms": graph_ms, "device_timer": timer, "timing_attempts": attempts,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": 0}


def check_k3(torch, k3):
    """Phase 3b: K3 against its plain version at (3, 128, 128) and at the
    select rounds' shapes, on logits scaled like the fake decoder's margins
    (timed); then, every count exact, on the adversarial cases."""
    from super_primitive_tpu_torch.eval.k3_cases import KINDS, k3_case

    g = torch.Generator().manual_seed(3)
    rows = []
    for N, S, hw in [(3, 128, (503, 491)), (384, 256, (768, 1024)), (96, 256, (768, 1024))]:
        x = (torch.randn(N, S, S, generator=g) * 4).cuda()
        rows.append(k3_row(torch, k3, x, 4, hw))
    checked = 0
    for kind in KINDS:
        for N, S, hw in [(96, 256, (768, 1024)), (96, 256, (503, 491)), (3, 128, (503, 491))]:
            x = k3_case(kind, N, S, 4, hw).cuda()
            for g_, w_ in zip(k3.phase_counts(x, 4, hw), k3.phase_counts_reference(x, 4, hw)):
                if not torch.equal(g_, w_):
                    fail(f"K3 disagrees with its plain version on {kind} at {N}x{S}² {hw}")
            checked += 1
    print(f"K3 adversarial cases ({', '.join(KINDS)}): {checked} inputs, every count exact",
          flush=True)
    return rows


def sam_frame_row(torch, sf, image, mid_hw, out_hw, predictor=None) -> dict:
    """The SAM frame's kernel against ``sam_frame_reference`` on one image,
    every byte equal; kernel (CUDA events over back-to-back calls) and plain
    (the two numpy resizes, host clock) times; the bound (bytes: the image
    and the tap tables read, the frame written).  With ``predictor``, also
    its whole ``prepare_frame`` of the image from a host array (staging
    copy, upload and kernel, synchronised; host clock), what the keyframe's
    ``sam_upload`` span holds."""
    H, W, _ = image.shape
    host = image.cpu()
    got = sf.sam_frame(image, mid_hw, out_hw).cpu()
    want = sf.sam_frame_reference(host, mid_hw, out_hw)
    err = int((got.int() - want.int()).abs().max())
    ms = time_ms(torch, lambda: sf.sam_frame(image, mid_hw, out_hw), reps=200)
    plain = []
    for _ in range(3):
        t0 = time.perf_counter()
        sf.sam_frame_reference(host, mid_hw, out_hw)
        plain.append((time.perf_counter() - t0) * 1e3)
    nbytes = host.numel() + want.numel() + sf.tap_tables((H, W), mid_hw, out_hw).nbytes
    b_ms, b_by = bound_ms(nbytes, 0)
    row = {"shape": [H, W], "mid_hw": list(mid_hw), "out_hw": list(out_hw),
           "max_abs_err": err, "ms": ms, "plain_ms": statistics.median(plain),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": 0}
    if predictor is not None:
        image_np, prep = host.numpy(), []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictor.prepare_frame(image_np, mid_hw)
            torch.cuda.synchronize()
            prep.append((time.perf_counter() - t0) * 1e3)
        row["prepare_frame_ms"] = statistics.median(prep)
    print(f"SAM frame {H}x{W} -> {tuple(mid_hw)} -> {tuple(out_hw)}: max abs err {err}; kernel "
          f"{ms * 1e3:.2f} us, plain {row['plain_ms']:.2f} ms, bound {b_ms * 1e3:.3f} us ({b_by})"
          + (f", prepare_frame {row['prepare_frame_ms']:.3f} ms" if predictor else ""),
          flush=True)
    if err != 0:
        fail(f"the SAM frame's kernel disagrees with its plain version at {H}x{W} -> "
             f"{tuple(mid_hw)} -> {tuple(out_hw)}")
    if ms < b_ms:
        fail(f"the SAM frame's kernel time at {H}x{W} is below its bound")
    return row


def check_sam_frame(torch, sf):
    """Phase 3c: the SAM frame's kernel against its plain version, byte for
    byte, at ``SAM_FRAME_CHECK_SHAPES`` on random images."""
    g = torch.Generator().manual_seed(5)
    return [sam_frame_row(torch, sf, torch.randint(0, 256, (*src, 3), generator=g,
                                                   dtype=torch.uint8).cuda(), mid, out)
            for src, mid, out in SAM_FRAME_CHECK_SHAPES]


def undecided_share(torch, k3, x, s, input_hw) -> float:
    """The share of the region's low-res pixels that K3's shortcut leaves to
    the full 16-phase path: those whose clamped 3x3 window is not finite or
    straddles a threshold's cutoffs (``phase_counts.phase_cutoffs``)."""
    N, S, _ = x.shape
    R, C = k3.region_lowres(S, s, input_hw)
    cut = k3.phase_cutoffs(s)
    xp = torch.nn.functional.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    mn, mx = xp[:, :S, :S], xp[:, :S, :S]
    for a in range(3):
        for b in range(3):
            w = xp[:, a:a + S, b:b + S]
            mn, mx = torch.minimum(mn, w), torch.maximum(mx, w)
    up = sum((mn >= c).int() for c in cut[:3])
    nb = sum((~(mx <= d)).int() for d in cut[3:])
    settled = (up == nb) & torch.isfinite(mn) & torch.isfinite(mx)
    return float((~settled[:, :R, :C]).float().mean())


def check_bini_480(torch, bini, stencil):
    """Phase 4: BiNI at 480x640 with 8 Voronoi masks, the K1 route, against
    the plain route; then K1 against its plain version on the inputs of
    this path's first non-trivial K1 call."""
    import numpy as np

    from super_primitive_tpu_torch.data.synthetic import PlanesSequence

    seq = PlanesSequence(n_frames=1, H=480, W=640)
    normals = torch.from_numpy(seq[0]["normals"]).cuda()
    K = torch.from_numpy(seq.K).cuda()
    r = np.random.default_rng(5)
    seeds = np.stack([r.uniform(0, 480, 8), r.uniform(0, 640, 8)], axis=1)
    v, u = np.mgrid[0:480, 0:640]
    labels = np.argmin((v[None] - seeds[:, 0, None, None]) ** 2
                       + (u[None] - seeds[:, 1, None, None]) ** 2, axis=0)
    masks = torch.from_numpy(labels[None] == np.arange(8)[:, None, None]).cuda()
    cfg = bini.BiniConfig(cg_max_iter=1000, cg_tol=1e-3)
    if stencil.cg_holds(480, 640):
        fail("480x640 no longer takes the K1 route")

    with first_inputs(torch, stencil, "bini_apply") as path_inputs:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zt_k = bini.integrate_normals(normals, masks, K, cfg)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        launches = launch_counts()
    t0 = time.perf_counter()
    zt_r = bini.integrate_normals(normals, masks, K, cfg, plain=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = float((zt_k - zt_r).abs().max())
    print(f"BiNI 480x640 x8: K1 launches {launches['bini_apply']}, K2 launches "
          f"{launches['bini_cg']}; kernel route {kernel_s:.2f} s, plain route "
          f"{plain_s:.2f} s; max |dlogdepth| {err:.2e}", flush=True)
    if launches["bini_apply"] == 0:
        fail("the 480x640 BiNI path launched no K1")
    if not (torch.isfinite(zt_k).all() and err <= 1e-3):
        fail("BiNI 480x640 disagrees with the plain route")
    rows = [k1_row(torch, stencil, *args) for args in path_inputs.values()]
    return launches, rows


def slice_config(H, W, small=False, disc=False, solver="adam"):
    from super_primitive_tpu_torch.config import load_config

    return load_config({
        "save_path": str(Path("build") / "chip_smoke" / f"{H}x{W}"),
        "dataset": {"type": "planes", "path": "linear", "source_id": 0, "target_id": 4},
        "frontend": {
            "downsample_pow": 0 if small else 1,
            "num_pts": 48 if small else 128,
            "num_pts_active": 16 if small else 32,
            "normals": {"integration_shape": [H // 2, W // 2], "network_dim": [H, W]},
            "cg_max_iter": 150 if small else 1000,
            "cg_tol": 1e-3,
            "check_for_depth_disc": disc,
        },
        "sam_params": {"infer_resolution": [H, W] if small else [H // 2, W // 2]},
        "alignment": {"pyramid_min": 0, "pyramid_max": 2 if small else 4,
                      "mapping": {"solver": solver}},
    })


def run_slice(torch, stencil):
    """Phase 5: the full-size two-frame slice on the card; then K2 against
    its plain version on the inputs of the path's first call at each crop
    bucket and field shape."""
    import numpy as np

    from super_primitive_tpu_torch.data.synthetic import PlanesSequence
    from super_primitive_tpu_torch.frontend.fakes import StructuredFakeFrontend
    from super_primitive_tpu_torch.run_sfm import run_two_frame

    cfg = slice_config(480, 640)
    ds = PlanesSequence(n_frames=5, H=480, W=640, path="linear")
    fe = StructuredFakeFrontend(cfg, n_cells=64, device="cuda")
    with first_inputs(torch, stencil, "bini_cg") as path_inputs:
        reset_launch_counts()
        r = run_two_frame(cfg, fe, ds, device="cuda")
        launches = launch_counts()
    drop = r["pose_err_init"] / max(r["pose_err_final"], 1e-12)
    print(f"slice 480x640: {r['num_segments']} segments, K2 launches "
          f"{launches['bini_cg']}, K1 launches {launches['bini_apply']}; frontend "
          f"{r['frontend_s']:.2f} s, solve {r['solve_s']:.2f} s; final loss "
          f"{r['final_loss']:.6f}; pose err |log| {r['pose_err_init']:.5f} -> "
          f"{r['pose_err_final']:.5f} ({drop:.1f}x)", flush=True)
    if launches["bini_cg"] == 0:
        fail("the two-frame slice launched no K2")
    if r["pose"].shape != (4, 4) or not np.isfinite(r["pose"]).all():
        fail("the slice's pose is not a finite 4x4 matrix")
    if r["kp_logdepth"].shape != (r["num_segments"],) or not np.isfinite(r["kp_logdepth"]).all():
        fail("the slice's depths are not finite per-segment scalars")
    if not (math.isfinite(r["final_loss"]) and drop >= 3.0):
        fail("the slice did not cut the pose error 3x")
    rows = [k2_row(torch, stencil, *args) for args in path_inputs.values()]
    return launches, rows, r


def scale_aligned_err(torch, T, T_gt) -> float:
    """|log(T_gt^-1 T')| with T's translation rescaled to the ground
    truth's length: the pose error that two views can observe (two-frame
    SfM leaves the scale of depth and translation free)."""
    import numpy as np

    from super_primitive_tpu_torch.lie import se3

    T = np.asarray(T, np.float64).copy()
    T[:3, 3] *= np.linalg.norm(T_gt[:3, 3]) / max(np.linalg.norm(T[:3, 3]), 1e-12)
    rel = np.linalg.inv(np.asarray(T_gt, np.float64)) @ T
    return float(torch.linalg.norm(se3.log(torch.from_numpy(rel.astype(np.float32)))))


def run_slice_gn(torch, stencil, k3, adam: dict):
    """Phase 5b: phase 5's two-frame problem with ``mapping.solver: gn``
    (``solve_two_frame_gn``, 30 LM iterations a level).  It must cut the
    scale-aligned pose error 3x; the raw |log| error is reported, not held:
    it is mostly the translation's scale, which two views leave free and the
    random depth seeds set, and GN moves along that direction where Adam's
    small depth rate barely does."""
    import numpy as np

    from super_primitive_tpu_torch.data.synthetic import PlanesSequence
    from super_primitive_tpu_torch.frontend.fakes import StructuredFakeFrontend
    from super_primitive_tpu_torch.run_sfm import run_two_frame

    cfg = slice_config(480, 640, solver="gn")
    ds = PlanesSequence(n_frames=5, H=480, W=640, path="linear")
    fe = StructuredFakeFrontend(cfg, n_cells=64, device="cuda")
    reset_launch_counts()
    r = run_two_frame(cfg, fe, ds, device="cuda")
    launches = launch_counts()
    if r["solver"] != "gn":
        fail(f"run_two_frame took {r['solver']} for mapping.solver: gn")
    aligned = {k: scale_aligned_err(torch, r[k], r["T_rel_gt"]) for k in ("T_init", "pose")}
    adam_aligned = scale_aligned_err(torch, adam["pose"], adam["T_rel_gt"])
    drop = aligned["T_init"] / max(aligned["pose"], 1e-12)
    levels = [tuple(float(c) for c in l) for l in r["losses"]]
    summary = {"segments": r["num_segments"], "launches": launches,
               "solve_s": r["solve_s"], "adam_solve_s": adam["solve_s"],
               "level_costs": levels, "pose_err_init": r["pose_err_init"],
               "pose_err_final": r["pose_err_final"],
               "adam_pose_err_final": adam["pose_err_final"],
               "aligned_err_init": aligned["T_init"], "aligned_err_final": aligned["pose"],
               "adam_aligned_err_final": adam_aligned}
    print(f"slice 480x640 GN: {r['num_segments']} segments, K2 launches {launches['bini_cg']}; "
          f"solve {r['solve_s']:.2f} s (Adam {adam['solve_s']:.2f} s); level costs (initial, "
          f"final) {[(round(a, 6), round(b, 6)) for a, b in levels]}; pose err |log| "
          f"{r['pose_err_init']:.5f} -> {r['pose_err_final']:.5f} (Adam "
          f"{adam['pose_err_final']:.5f}); scale-aligned {aligned['T_init']:.5f} -> "
          f"{aligned['pose']:.5f} ({drop:.1f}x; Adam {adam_aligned:.5f})", flush=True)
    if launches["bini_cg"] == 0:
        fail("the GN two-frame slice launched no K2")
    if r["pose"].shape != (4, 4) or not np.isfinite(r["pose"]).all():
        fail("the GN slice's pose is not a finite 4x4 matrix")
    if not np.isfinite(r["kp_logdepth"]).all():
        fail("the GN slice's depths are not finite")
    if drop < 3.0:
        fail("the GN slice did not cut the scale-aligned pose error 3x")
    return launches, summary


def small_input_agreement(torch):
    """Phase 6: at 96x128 the card agrees with the CPU (plain versions): the
    frontend gives identical regions and keypoints and log-depths within
    1e-3, with the host FakeSAM and with the device SAM selection and the
    depth split; the photometric cost at the solve's init, relative 1e-5,
    and its gradients, relative 1e-4 of their largest entry."""
    import numpy as np

    from super_primitive_tpu_torch.cost import photometric as ph
    from super_primitive_tpu_torch.data.synthetic import PlanesSequence
    from super_primitive_tpu_torch.frontend.fakes import StructuredFakeFrontend
    from super_primitive_tpu_torch.lie import se3
    from super_primitive_tpu_torch.ops.sampling import pack_bilinear_taps
    from super_primitive_tpu_torch.run_sfm import make_pyramids

    cfg = slice_config(96, 128, small=True)
    ds = PlanesSequence(n_frames=5, H=96, W=128)
    src, trg = ds[0], ds[4]
    kf, supp = {}, {}
    for dev in ("cuda", "cpu"):
        fe = StructuredFakeFrontend(cfg, n_cells=24, device=dev)
        fe.observe(src)
        kf[dev] = fe.process_to_kf(src["image"], src["intrinsics"])
        supp[dev] = fe.process_to_supp_kf(trg["image"], trg["intrinsics"])
    ld_err = float(np.abs(kf["cuda"]["logdepth_perseg"] - kf["cpu"]["logdepth_perseg"]).max())
    same = (np.array_equal(kf["cuda"]["regions"], kf["cpu"]["regions"])
            and np.array_equal(kf["cuda"]["keypoints_rc"], kf["cpu"]["keypoints_rc"]))
    kf_d = {}
    for dev in ("cuda", "cpu"):
        fe = StructuredFakeFrontend(slice_config(96, 128, small=True, disc=True), n_cells=24,
                                    device=dev, device_sam=True)
        fe.observe(src)
        kf_d[dev] = fe.process_to_kf(src["image"], src["intrinsics"])
    ld_err_d = float(np.abs(kf_d["cuda"]["logdepth_perseg"]
                            - kf_d["cpu"]["logdepth_perseg"]).max())
    same_d = (np.array_equal(kf_d["cuda"]["regions"], kf_d["cpu"]["regions"])
              and np.array_equal(kf_d["cuda"]["keypoints_rc"], kf_d["cpu"]["keypoints_rc"]))
    print(f"96x128 card vs CPU, device SAM + split: {kf_d['cpu']['regions'].shape[0]} "
          f"segments, regions/keypoints identical {same_d}, max |dlogdepth| "
          f"{ld_err_d:.2e}", flush=True)
    if not (same_d and ld_err_d <= 1e-3):
        fail("the card disagrees with the CPU on the device-selection keyframe")

    T_init = (np.linalg.inv(trg["T"]) @ src["T"]).astype(np.float32)
    T_init = T_init @ se3.exp(torch.full((6,), 0.02)).numpy()
    out = {}
    for dev in ("cuda", "cpu"):
        src_pyr, trg_pyr = make_pyramids(cfg, kf["cpu"], supp["cpu"], dev)
        geo, bundle = src_pyr.geo, src_pyr.bundle
        ld = torch.full((geo.num_segments,), 1.0, device=dev, requires_grad=True)
        xi = torch.zeros(6, device=dev, requires_grad=True)
        pose = torch.from_numpy(T_init).to(dev) @ se3.exp(xi)
        samples = ph.precompute_source(src_pyr.images[-1], bundle, geo.geo_dims)
        cost = ph.photometric_cost(
            bundle, samples, pack_bilinear_taps(trg_pyr.images[-1]), src_pyr.K,
            geo.geo_dims, ld, geo.keypoint_base_logdepth(), pose)
        cost.backward()
        out[dev] = (float(cost.detach()), ld.grad.cpu(), xi.grad.cpu())
    cost_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_err = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(out["cuda"][1:], out["cpu"][1:]))
    print(f"96x128 card vs CPU: regions/keypoints identical {same}, max "
          f"|dlogdepth| {ld_err:.2e}; cost rel err {cost_err:.2e}, grad rel err "
          f"{grad_err:.2e}", flush=True)
    if not (same and ld_err <= 1e-3 and cost_err <= 1e-5 and grad_err <= 1e-4):
        fail("the card disagrees with the CPU on the small input")


# phase 6's GN checks, card against CPU: the bounds tests/test_torch_gn.py
# holds the port to against JAX on the CPU, but for a track's cost after a
# fixed LM budget (25 iterations that do not converge at 96x128): one ulp of
# the start pose's translation moves it by 6.5e-5 relative on the CPU, so
# its bound is 2e-4 (the CPU tests' problems converge, 1e-5)
GN_TOL = {"pose": 1e-4, "cost_rel": 1e-5, "final_cost_rel": 2e-4, "H": 5e-4, "g_t": 5e-5,
          "D": 5e-4, "gl": 5e-5, "Bs": 5e-4, "step": 1e-4, "logdepth": 5e-4,
          "gate_rel": 1e-4, "affine": 1e-6}


def gn_windows(torch, ds):
    """The window of tests/test_torch_gn.py at 96x128 on the card and on the
    CPU: keyframes 0, 3, 6 from the GT-depth grid stub (3x4 segments), one
    supporting frame each (the next frame, at its true pose), keyframes 1
    and 2 with seeded pose and log-depth perturbations."""
    import numpy as np

    from super_primitive_tpu_torch.frontend.stub import GridSegmentFrontend
    from super_primitive_tpu_torch.keyframe import build_bundle_np
    from super_primitive_tpu_torch.lie import se3
    from super_primitive_tpu_torch.odometry import window as win

    r = np.random.default_rng(0)
    fe = GridSegmentFrontend(rows=3, cols=4)
    slots = []
    for slot, fid in enumerate((0, 3, 6)):
        fe.observe(ds[fid])
        kf = fe.process_to_kf(ds[fid]["image"], ds[fid]["intrinsics"])
        n = kf["regions"].shape[0]
        kp_base = kf["logdepth_perseg"][np.arange(n), kf["keypoints_rc"][:, 0],
                                        kf["keypoints_rc"][:, 1]]
        pose, kp_ld = np.asarray(ds[fid]["T"], np.float32), kp_base.copy()
        if slot > 0:
            xi = torch.from_numpy((0.01 * r.normal(size=6)).astype(np.float32))
            pose = se3.retract(torch.from_numpy(pose), xi).numpy()
            kp_ld = kp_base + r.normal(0, 0.02, n).astype(np.float32)
        slots.append((kf, pose, kp_ld, kp_base, ds[fid + 1]))
    H, W = slots[0][0]["image"].shape[:2]
    out = {}
    for dev in ("cuda", "cpu"):
        w = win.empty_window(3, 2, (H, W), 3, 16, 2 * H * W, device=dev)
        for slot, (kf, pose, kp_ld, kp_base, supp) in enumerate(slots):
            bundle = build_bundle_np(kf["regions"], kf["logdepth_perseg"], capacity=2 * H * W,
                                     device=dev)
            win.set_keyframe_slot(w, slot, kf["image"], kf["K"], pose, kp_ld,
                                  np.zeros(2, np.float32), bundle, kp_base)
            img = torch.from_numpy(np.asarray(supp["image"], np.float32)).to(dev)
            win.set_supporting_slot(w, slot, 0, img, supp["T"], np.zeros(2, np.float32))
        out[dev] = w
    return out


def gn_card_vs_cpu(torch):
    """Phase 6, the GN path: at 96x128 the card agrees with the CPU on
    ``gn_track`` (one level), one ``assemble`` plus ``solve_step``,
    ``run_supp_refinement_gn`` and ``fused_frame_step`` within ``GN_TOL``;
    and two ``assemble`` calls on the card agree bit for bit (the landmark
    segment sums take a fixed order)."""
    import numpy as np

    from super_primitive_tpu_torch.cost import photometric as ph
    from super_primitive_tpu_torch.data.synthetic import PlanesSequence
    from super_primitive_tpu_torch.lie import se3
    from super_primitive_tpu_torch.odometry import mapper
    from super_primitive_tpu_torch.odometry.fused_step import fused_frame_step
    from super_primitive_tpu_torch.solve import gauss_newton as gn
    from super_primitive_tpu_torch.solve import gn_mapping as gm

    ds = PlanesSequence(n_frames=9, H=96, W=128, path="linear")
    wins = gn_windows(torch, ds)
    geo = tuple(wins["cpu"].images.shape[1:3])
    errs, iters = {}, {}

    def pose_err(A, B):
        rel = torch.linalg.inv(A.cpu().double()) @ B.cpu().double()
        return float(torch.linalg.norm(se3.log(rel.float())))

    def rel_max(a, b):
        a, b = a.detach().cpu(), b.detach().cpu()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-6))

    # gn_track: keyframe 0 against frame 2 from a perturbed start
    T_init = se3.retract(torch.from_numpy(ds[2]["T"]),
                         torch.tensor([0.01, -0.015, 0.01, -0.02, 0.03, 0.02]))
    R0 = torch.linalg.inv(T_init) @ wins["cpu"].poses[0]
    trg = torch.from_numpy(np.asarray(ds[2]["image"], np.float32))
    track = {}
    for dev, w in wins.items():
        b = w.bundle_at(0)
        src = ph.precompute_source(w.images[0], b, geo)
        z = torch.zeros(2, device=dev)
        track[dev] = gn.gn_track(b, src, trg.to(dev), w.K[0], w.kp_logdepth[0], w.kp_base[0],
                                 R0.to(dev), z, z, geo, max_iters=25)
    iters["track"] = {d: r.num_iters for d, r in track.items()}
    errs["track_pose"] = pose_err(track["cuda"].R, track["cpu"].R)
    for k in ("initial_cost", "final_cost"):
        errs[f"track_{k}_rel"] = abs(float(getattr(track["cuda"], k))
                                     / float(getattr(track["cpu"], k)) - 1)

    # one assemble and solve_step on the window's 'map' problem
    supp_valid = wins["cpu"].supp_valid.numpy()
    slots = mapper.build_slots(3, 3, supp_valid, "map")
    masks = mapper.build_masks(3, 3, supp_valid, "map", 3, False, False)
    pm = np.concatenate([np.repeat(masks.xi_mask, 6), np.repeat(masks.affine_mask, 2)])

    def assemble(w):
        return gm.assemble(w, slots.trg_index, slots.trg_valid, slots.src_valid,
                           torch.from_numpy(pm).to(w.images.device), geo, False, w.pose_pool(),
                           w.kp_logdepth, w.affine_pool())

    lin = {dev: assemble(w) for dev, w in wins.items()}
    again = assemble(wins["cuda"])
    deterministic = all(torch.equal(a, b) for a, b in zip(lin["cuda"], again))
    for k, name in enumerate(("H", "g_t", "D", "gl", "Bs")):
        errs[name] = rel_max(lin["cuda"][k], lin["cpu"][k])
    errs["assemble_cost_rel"] = rel_max(lin["cuda"][5], lin["cpu"][5])
    ld_w = (torch.from_numpy(masks.ld_mask)[:, None]
            * wins["cpu"].kf_valid.float()[:, None]).expand(3, 16)
    cmap = torch.from_numpy(gm.build_cmap(slots.trg_index, 9))
    steps = {dev: gm.solve_step(*(x.to(dev) for x in lin["cpu"][:5]),
                                torch.tensor(1e-3, device=dev), ld_w.to(dev),
                                torch.from_numpy(pm).to(dev), cmap.to(dev))
             for dev in ("cuda", "cpu")}
    errs["step"] = max(rel_max(a, b) for a, b in zip(steps["cuda"], steps["cpu"]))

    # GN supp refinement of keyframe 2
    sslots = mapper.build_slots(3, 3, supp_valid, "supp")
    supp = {dev: mapper.run_supp_refinement_gn(w, 2, sslots.trg_index[2], sslots.trg_valid[2],
                                               False, geo)
            for dev, w in wins.items()}
    iters["supp"] = {d: r[2] for d, r in supp.items()}
    errs["supp_logdepth"] = float((supp["cuda"][0].cpu() - supp["cpu"][0]).abs().max())
    errs["supp_cost"] = float((supp["cuda"][1].cpu() - supp["cpu"][1]).abs().max())

    # the fused step on keyframe 2 with frame 8, frame 7 the previous one
    sv = supp_valid.copy()
    sv[2] = [True, True]
    fslots = mapper.build_slots(3, 3, sv, "supp")
    T_init = se3.retract(torch.from_numpy(ds[8]["T"]),
                         torch.tensor([0.005, 0.0, 0.0, 0.01, 0.0, 0.0]))
    fused = {}
    for dev, w in wins.items():
        img = {k: torch.from_numpy(np.asarray(ds[k]["image"], np.float32)).to(dev)
               for k in (7, 8)}
        z = torch.zeros(2, device=dev)
        fused[dev] = fused_frame_step(
            w, 2, img[8], T_init.to(dev), z, img[7],
            torch.from_numpy(ds[7]["T"]).to(dev), z, fslots.trg_index[2],
            fslots.trg_valid[2], geo, [1], 0, 2, max_iters=15)
    pc, pk = fused["cpu"].packed, fused["cuda"].packed
    errs["fused_pose"] = pose_err(torch.from_numpy(pk[:16].reshape(4, 4)),
                                  torch.from_numpy(pc[:16].reshape(4, 4)))
    errs["fused_affine"] = float(np.abs(pk[16:18] - pc[16:18]).max())
    errs["fused_gate_rel"] = float(np.max(np.abs(pk[18:21] - pc[18:21])
                                          / np.maximum(np.abs(pc[18:21]), 1e-12)))
    errs["fused_cost_rel"] = float(abs(pk[21] / pc[21] - 1))
    errs["fused_logdepth"] = float((fused["cuda"].kp_logdepth.cpu()
                                    - fused["cpu"].kp_logdepth).abs().max())
    iters["fused"] = {d: (r.track_iters, r.supp_iters) for d, r in fused.items()}
    print(f"96x128 GN card vs CPU: {json.dumps(errs)}; LM iterations (card, CPU) "
          f"{json.dumps(iters)}; two assembles on the card bit-identical {deterministic}",
          flush=True)
    limits = {"track_pose": GN_TOL["pose"], "track_initial_cost_rel": GN_TOL["cost_rel"],
              "track_final_cost_rel": GN_TOL["final_cost_rel"],
              **{k: GN_TOL[k] for k in ("H", "g_t", "D", "gl", "Bs", "step")},
              "assemble_cost_rel": GN_TOL["cost_rel"], "supp_logdepth": GN_TOL["logdepth"],
              "supp_cost": GN_TOL["cost_rel"], "fused_pose": GN_TOL["pose"],
              "fused_affine": GN_TOL["affine"], "fused_gate_rel": GN_TOL["gate_rel"],
              "fused_cost_rel": GN_TOL["final_cost_rel"], "fused_logdepth": GN_TOL["logdepth"]}
    bad = [k for k, v in errs.items() if not v <= limits[k]]
    if bad:
        fail(f"the card disagrees with the CPU on the GN path: {bad}")
    if not deterministic:
        fail("two assemble calls on the card differ")
    return {"errors": errs, "lm_iters": iters, "assemble_bit_identical": deterministic}


def run_vo(torch, stencil, k3):
    """Phase 7: the VO slice at full width on the card; then K2 and K3
    against their plain versions on the inputs of the path's first call at
    each shape."""
    from super_primitive_tpu_torch.eval.e2e_synthetic import run_e2e

    with first_inputs(torch, stencil, "bini_cg") as k2_inputs, \
            first_inputs(torch, k3, "phase_counts") as k3_inputs:
        reset_launch_counts()
        r = run_e2e("adam", frames=ADAM_VO_FRAMES, device="cuda",
                    save_path=str(Path("build") / "chip_smoke" / "vo"))
        launches = launch_counts()
    timer, ate = r["timer"], r["ate"]["rmse"]
    track = timer.summary()["track"]
    kf_s = [w for _, w, _ in r["kf_add_log"]]
    segs = [n for _, _, n in r["kf_add_log"]]
    stages = ("normals", "sam_round1", "sam_round2", "sam_edges", "sam_masks", "bini",
              "host_pack", "split_disc", "split_cc", "split_parts", "split", "kf_frontend",
              "kf_depth_reinit", "kf_slot_put", "track", "mapping_init", "mapping_map",
              "mapping_supp", "gating")
    split = {k: round(timer.totals[k], 4) for k in stages if k in timer.totals}
    summary = {"frames": r["frames"], "keyframes": r["keyframes"], "wall_s": r["wall_s"],
               "ms_per_tracked_frame": track["mean_ms"], "kf_add_s": kf_s,
               "segments_per_kf": segs, "ate_sim3": ate, "launches": launches,
               "stage_s": split}
    print(f"VO slice 480x640, {r['frames']} frames: {r['keyframes']} keyframes, wall "
          f"{r['wall_s']:.2f} s, {track['mean_ms']:.1f} ms per tracked frame, keyframe add "
          f"{', '.join(f'{w:.2f}' for w in kf_s)} s, segments {segs}, Sim(3) ATE {ate:.5f}; "
          f"launches {launches}", flush=True)
    print("VO stage seconds: " + json.dumps(split), flush=True)
    if launches["bini_cg"] == 0 or launches["phase_counts"] == 0:
        fail("the VO slice did not launch K2 and K3")
    if r["keyframes"] < 2:
        fail("the VO slice made fewer than 2 keyframes")
    if not (math.isfinite(ate) and ate < 0.05):
        fail(f"the VO slice's Sim(3) ATE {ate} is not below 0.05")
    k2_rows = [k2_row(torch, stencil, *args) for args in k2_inputs.values()]
    k3_rows = [k3_row(torch, k3, *args) for args in k3_inputs.values()]
    for row, args in zip(k3_rows, k3_inputs.values()):
        row["undecided_share"] = undecided_share(torch, k3, *args)
    print("K3 shortcut on the VO path's inputs: " + ", ".join(
        f"{r['shape'][0]} slabs {100 * r['undecided_share']:.2f}% of region pixels to the full "
        "path" for r in k3_rows), flush=True)
    recorded = {"bini_cg": list(k2_inputs.values()), "phase_counts": list(k3_inputs.values())}
    return launches, k2_rows, k3_rows, summary, recorded


def check_new_inputs(torch, stencil, k3, recorded: dict, checked: dict) -> dict:
    """K2 and K3 against their plain versions on each recorded input that an
    earlier check did not already see: K2's solution within 1e-4 x max|x|
    with equal iterations where the solutions are equal, K3 exact.  Returns
    {kernel: (inputs, new ones checked, max abs err)}."""
    def same_args(a, b):
        return len(a) == len(b) and all(
            torch.equal(x, y) if torch.is_tensor(x) else x == y for x, y in zip(a, b))

    out = {}
    for name, calls in recorded.items():
        new = [a for a in calls if not any(same_args(a, b) for b in checked[name])]
        err = 0.0
        for args in new:
            if name == "bini_cg":
                x_k, it_k = stencil.bini_cg(*args)
                x_r, it_r = stencil.bini_cg_reference(*args)
                e = float((x_k - x_r).abs().max())
                same = [bool(torch.equal(a, c)) for a, c in zip(x_k, x_r)]
                iters_agree = all(int(i) == int(j) for i, j, sm in zip(it_k, it_r, same) if sm)
                if not (e <= 1e-4 * float(x_r.abs().max()) and iters_agree):
                    fail(f"K2 disagrees with its plain version at {tuple(args[0].shape)}")
            else:
                got, want = k3.phase_counts(*args), k3.phase_counts_reference(*args)
                e = max(float((g - w).abs().max()) for g, w in zip(got, want))
                if e != 0:
                    fail(f"K3 disagrees with its plain version at {tuple(args[0].shape)}")
            err = max(err, e)
        out[name] = {"inputs": len(calls), "new_checked": len(new), "max_abs_err": err}
    return out


def run_vo_gn(torch, stencil, k3, adam: dict, adam_inputs: dict):
    """Phase 7b: ``run_e2e("gn")`` at full width on the card (tracking at
    level 2 only, 30 LM iterations; GN mapping, the mono init's with the
    scale gauge pinned; fused frames after it), through the same frontend on
    K3 and K2; then the kernels against their plain versions on the path's
    inputs that phase 7 did not see.  Keeps, for phase 11, a copy of the
    window and arguments of its ``gn_mapping`` call over the most keyframes
    and of its first BiNI call at each crop bucket."""
    import numpy as np

    from super_primitive_tpu_torch.eval.e2e_synthetic import run_e2e
    from super_primitive_tpu_torch.frontend import process_frame
    from super_primitive_tpu_torch.odometry import odometry

    kept = {"gn": {}, "bini": {}}
    with first_inputs(torch, stencil, "bini_cg") as k2_inputs, \
            first_inputs(torch, k3, "phase_counts") as k3_inputs, \
            kept_calls(odometry, "gn_mapping", keep_fullest_gn(kept["gn"])), \
            kept_calls(process_frame, "integrate_normals_cropped", keep_first_bini(kept["bini"])):
        reset_launch_counts()
        r = run_e2e("gn", frames=VO_FRAMES, device="cuda",
                    save_path=str(Path("build") / "chip_smoke" / "vo_gn"))
        launches = launch_counts()
    kept = host_copy(kept)
    timer, odom, ate = r["timer"], r["odom"], r["ate"]["rmse"]
    counts, totals = timer.counts, timer.totals
    tracked = counts.get("fused_frame", 0) + counts.get("track", 0)
    track_s = totals.get("fused_frame", 0.0) + totals.get("track", 0.0)
    stages = ("fused_frame", "fused_track", "fused_supp", "fused_gating", "track",
              "mapping_init", "mapping_map", "mapping_supp", "gating", "kf_frontend")
    split = {k: round(totals[k], 4) for k in stages if k in totals}
    split_counts = {k: counts.get(k, 0) for k in stages}
    lm = {k: {"calls": len(v), "mean": float(np.mean(v)), "max": max(v)}
          for k, v in odom.gn_iters.items() if v}
    reads = timer.syncs.get("fused_frame", 0) / max(counts.get("fused_frame", 0), 1)
    finite = all(np.isfinite(np.asarray(T)).all()
                 for T in odom.global_track_trajectory.values())
    summary = {"frames": r["frames"], "keyframes": r["keyframes"], "wall_s": r["wall_s"],
               "ms_per_tracked_frame": 1000 * track_s / max(tracked, 1),
               "fused_frames": counts.get("fused_frame", 0),
               "unfused_tracked_frames": counts.get("track", 0),
               "kf_add_s": [w for _, w, _ in r["kf_add_log"]], "ate_sim3": ate,
               "launches": launches, "stage_s": split, "stage_calls": split_counts,
               "lm_iters": lm,
               "host_reads_per_fused_frame": reads,
               "adam": {k: adam[k] for k in ("wall_s", "ms_per_tracked_frame", "keyframes",
                                             "ate_sim3")}}
    print(f"VO slice GN 480x640, {r['frames']} frames: {r['keyframes']} keyframes, wall "
          f"{r['wall_s']:.2f} s (Adam {adam['wall_s']:.2f}), "
          f"{summary['ms_per_tracked_frame']:.1f} ms per tracked frame (Adam "
          f"{adam['ms_per_tracked_frame']:.1f}), Sim(3) ATE {ate:.5f} (Adam "
          f"{adam['ate_sim3']:.5f}); {reads:.1f} host reads per fused frame; LM iterations "
          f"{json.dumps(lm)}; launches {launches}", flush=True)
    print(f"VO GN stage seconds: {json.dumps(split)}; calls {json.dumps(split_counts)}",
          flush=True)
    if launches["bini_cg"] == 0 or launches["phase_counts"] == 0:
        fail("the GN VO slice did not launch K2 and K3")
    if r["keyframes"] < 2:
        fail("the GN VO slice made fewer than 2 keyframes")
    if not (math.isfinite(ate) and ate < 0.05):
        fail(f"the GN VO slice's Sim(3) ATE {ate} is not below 0.05")
    if not (counts.get("fused_frame", 0) > 0 and counts.get("mapping_supp", 0) == 0):
        fail("the GN VO slice did not take the fused step, or mapped 'supp' apart from it")
    if not finite:
        fail("the GN VO slice has a non-finite pose")
    recorded = {"bini_cg": list(k2_inputs.values()), "phase_counts": list(k3_inputs.values())}
    summary["kernel_checks"] = check_new_inputs(torch, stencil, k3, recorded, adam_inputs)
    print("kernels on the GN VO path's inputs: " + json.dumps(summary["kernel_checks"]),
          flush=True)
    summary["device_busy"] = gn_busy(torch, odom)
    if not kept["gn"] or not kept["bini"]:
        fail("the GN VO slice made no gn_mapping or no cropped BiNI call to keep")
    return launches, summary, kept


def gn_busy(torch, odom) -> dict:
    """Where a GN call's time goes, on the run's last state: one
    ``gn_track`` of the last tracked frame against the newest keyframe
    (30 LM iterations at the tracked level) and one ``assemble`` of the
    window's 'map' problem; each call's time (CUDA events, after a warm-up),
    the device's busy time and kernel count in it (torch.profiler), and the
    idle share."""
    import numpy as np

    from super_primitive_tpu_torch.cost import photometric as ph
    from super_primitive_tpu_torch.image import pyramid as pyr
    from super_primitive_tpu_torch.odometry import mapper
    from super_primitive_tpu_torch.solve import gauss_newton as gn
    from super_primitive_tpu_torch.solve import gn_mapping as gm

    b, i, geo = odom.buffers, odom.num_kfs - 1, odom._geo_dims()
    t = odom.config.alignment.track
    lv = odom._track_levels()[-1]
    kf_img = pyr.image_pyramid(b.images[i], t.pyramid_min, t.pyramid_max)[lv]
    trg = odom.tracked[-1].image if odom.tracked else b.images[i]
    trg_img = pyr.image_pyramid(trg, t.pyramid_min, t.pyramid_max)[lv]
    bundle = b.bundle_at(i)
    src = ph.precompute_source(kf_img, bundle, geo)
    z = torch.zeros(2, device="cuda")
    R = torch.linalg.inv(odom._tensor(odom.current_track)) @ b.poses[i]
    iters = []

    def track():
        r = gn.gn_track(bundle, src, trg_img, b.K[i], b.kp_logdepth[i], b.kp_base[i], R, z, z,
                        geo, max_iters=30)
        iters.append(r.num_iters)

    supp_valid = odom.supp_valid_host
    slots = mapper.build_slots(odom.num_kfs, odom.window_size, supp_valid, "map")
    masks = mapper.build_masks(odom.num_kfs, odom.window_size, supp_valid, "map",
                               odom.window_size, True, False)
    pm = torch.from_numpy(np.concatenate([np.repeat(masks.xi_mask, 6),
                                          np.repeat(masks.affine_mask, 2)])).cuda()
    sources = gm.prepare_sources(b, slots.trg_index, slots.trg_valid, slots.src_valid, geo)

    def assemble():
        gm.assemble(b, slots.trg_index, slots.trg_valid, slots.src_valid, pm, geo, False,
                    b.pose_pool(), b.kp_logdepth, b.affine_pool(), sources=sources)

    out = {"track_points": bundle.num_valid, "track_level_hw": list(trg_img.shape[:2]),
           "assemble_sources": len(sources)}
    for name, fn in (("gn_track", track), ("assemble", assemble)):
        ms = time_ms(torch, fn, reps=3)
        busy, kernels = busy_ms(torch, fn)
        out[name] = {"ms": ms, "busy_ms": busy, "kernels": kernels, "idle_share": 1 - busy / ms}
    out["gn_track"]["lm_iters"] = iters[-1]
    print("GN calls on the card: " + json.dumps(out), flush=True)
    return out


def busy_ms(torch, fn) -> tuple[float, int]:
    """(ms, records): the summed durations of the device's kernels, copies
    and memsets in one call of ``fn`` (after a warm-up), from
    torch.profiler's CUDA activity; one stream, so nothing overlaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not us:
        fail("torch.profiler saw no device activity")
    return sum(us) / 1e3, len(us)


def rel_err(got, want) -> float:
    want = want.detach().float().cpu()
    return float((got.detach().float().cpu() - want).abs().max() / want.abs().max())


def real_nets_config(pkg_dir: Path):
    """``configs/planes_odom.yaml`` with the filter that drops a mask whose
    prompt does not lie on it off (``filter_edge_points``): random weights
    cannot segment around their prompt."""
    import dataclasses

    from super_primitive_tpu_torch.config import load_config

    cfg = load_config(str(pkg_dir / "configs" / "planes_odom.yaml"))
    sam = dataclasses.replace(cfg.sam_params, filter_edge_points=False)
    return dataclasses.replace(cfg, sam_params=sam,
                               save_path=str(Path("build") / "chip_smoke" / "real_nets"))


def nets_card_vs_cpu(torch, p32, nnet, sam_img, image_u8, network_dim, pts) -> dict:
    """Phase 8's float32 agreement: ViT-H block 0 (windowed, 25 windows of
    14² over the 64x64 grid padded to 70) and the first global block on
    the activations the card's encoder gives them; the prompt encoder and
    decoder on the card's features for ``pts``; the NNET at
    ``network_dim``.  Each against a copy of the module on the CPU, relative
    to the largest CPU magnitude, except the NNET's unit normals and kappa
    (absolute)."""
    import copy

    from super_primitive_tpu_torch.nets.nnet import preprocess
    from super_primitive_tpu_torch.nets.sam.predictor import decode_prompts

    def on_cpu(module):
        return copy.deepcopy(module).to("cpu")

    enc = p32.model.image_encoder
    blocks = (0, p32.cfg.global_attn_indexes[0])
    seen = {}
    hooks = [enc.blocks[i].register_forward_pre_hook(
        lambda m, a, i=i: seen.setdefault(i, a[0].clone())) for i in blocks]
    p32.set_image(sam_img)
    for h in hooks:
        h.remove()
    errs = {}
    for i in blocks:
        x, blk = seen[i], enc.blocks[i]
        errs[f"block{i}"] = rel_err(blk(x), on_cpu(blk)(x.cpu()))
    masks, iou = p32._decode(pts.cuda())
    pe = on_cpu(p32.model.prompt_encoder)
    masks_c, iou_c = decode_prompts(pe, on_cpu(p32.model.mask_decoder), p32._features.cpu(),
                                    pe.get_dense_pe(), pts)
    errs["decoder_masks"] = rel_err(masks, masks_c)
    errs["decoder_iou"] = rel_err(iou, iou_c)
    img = torch.from_numpy(image_u8).cuda().permute(2, 0, 1).float() / 255.0
    x = preprocess(img, network_dim)
    errs["nnet"] = float((nnet(x).cpu() - on_cpu(nnet)(x.cpu())).abs().max())
    print("real nets, card vs CPU (float32, TF32 off): " + json.dumps(errs), flush=True)
    bad = [k for k, v in errs.items() if v > NET_CARD_TOL[k.split("_")[0].rstrip("0123456789")]]
    if bad:
        fail(f"the card disagrees with the CPU on {bad} beyond {NET_CARD_TOL}")
    return errs


def bf16_vs_f32(torch, p16, p32, img_dev, pts) -> dict:
    """The bf16 SAM (the frontend's precision) against the float32 one on
    the same weights: the encoder's features, and the decoded logits and
    IoU each decoded on its own features; relative to the float32 run's
    largest magnitude."""
    f16, f32 = p16.encode(img_dev), p32.encode(img_dev)
    p16._features, p32._features = f16, f32
    (m16, i16), (m32, i32) = p16._decode(pts), p32._decode(pts)
    errs = {"features": rel_err(f16, f32), "logits": rel_err(m16, m32),
            "iou": rel_err(i16, i32)}
    print("real nets, bf16 vs float32: " + json.dumps(errs), flush=True)
    bad = [k for k, v in errs.items() if v > BF16_TOL[k]]
    if bad:
        fail(f"bf16 SAM departs from float32 on {bad} beyond {BF16_TOL}")
    return errs


def run_real_nets(torch, stencil, k3, pkg_dir: Path, card: str):
    """Phase 8: the real nets at full width through the frontend, two
    keyframes, a supporting frame and a 4-frame VO run on the card; then K3
    and K2 against their plain versions on the inputs the real nets gave
    them, and the nets' times.  Also returns the synthetic weights (host
    state dicts, phase 13's)."""
    import numpy as np

    from super_primitive_tpu_torch.data.synthetic import PlanesSequence
    from super_primitive_tpu_torch.eval.trajectory import ate_rmse
    from super_primitive_tpu_torch.frontend.process_frame import frontend_from_state_dicts
    from super_primitive_tpu_torch.image.resize import linear_resize
    from super_primitive_tpu_torch.nets.sam.image_encoder import VIT_H
    from super_primitive_tpu_torch.nets.sam.predictor import SamPredictor
    from super_primitive_tpu_torch.nets.synth import (
        scale_like_trained,
        synth_nnet_state_dict,
        synth_sam_state_dict,
    )
    from super_primitive_tpu_torch.ops import sam_frame as sf
    from super_primitive_tpu_torch.run_sfm import run_odometry
    from super_primitive_tpu_torch.utils.timing import StageTimer

    t_phase = t0 = time.perf_counter()
    weights = {"sam": synth_sam_state_dict(VIT_H), "nnet": synth_nnet_state_dict()}
    synth_s = time.perf_counter() - t0
    cfg = real_nets_config(pkg_dir)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fe = frontend_from_state_dicts(cfg, weights["sam"], weights["nnet"], "cuda")
    # the precision checks run on the weights at a trained net's scale
    sd = scale_like_trained(weights["sam"])
    p32 = SamPredictor(sd, VIT_H, device="cuda")
    p16 = SamPredictor(sd, VIT_H, compute_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del sd
    predictor, nnet = fe.mask_predict_fn.predictor, fe.normals_fn.model
    print(f"real nets: synthetic weights {synth_s:.1f} s, loaded (SAM bf16, and bf16 and "
          f"float32 on the scaled weights; NNET) {load_s:.1f} s", flush=True)

    ds = PlanesSequence(n_frames=REAL_NET_FRAMES, H=480, W=640, path="linear")
    image_u8 = (np.clip(ds[0]["image"], 0, 1) * 255).astype(np.uint8)
    sam_img = linear_resize(image_u8, tuple(cfg.sam_params.infer_resolution))
    img_dev = predictor._upload(sam_img)
    h2w2 = tuple(img_dev.shape[:2])
    r = np.random.default_rng(8)
    pts = torch.from_numpy((r.random((cfg.frontend.num_pts_active, 2))
                            * [h2w2[1] - 1, h2w2[0] - 1]).round().astype(np.float32))
    errs = nets_card_vs_cpu(torch, p32, nnet, sam_img, image_u8,
                            tuple(cfg.frontend.normals.network_dim), pts)
    errs_bf16 = bf16_vs_f32(torch, p16, p32, img_dev, pts.cuda())
    del p16

    fe.timer = StageTimer("cuda")
    kf_s, segs = [], []
    with first_inputs(torch, stencil, "bini_cg") as k2_inputs, \
            first_inputs(torch, k3, "phase_counts") as k3_inputs, \
            first_inputs(torch, sf, "sam_frame") as sf_inputs:
        reset_launch_counts()
        for i in (0, 1):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kf = fe.process_to_kf(ds[i]["image"], ds[i]["intrinsics"])
            torch.cuda.synchronize()
            kf_s.append(time.perf_counter() - t0)
            segs.append(int(kf["regions"].shape[0]))
            d_k3 = k3.launch_counts["phase_counts"] - before["phase_counts"]
            d_k2 = stencil.launch_counts["bini_cg"] - before["bini_cg"]
            d_sf = sf.launch_counts["sam_frame"] - before["sam_frame"]
            if d_sf != 1:
                fail(f"real-net keyframe {i} launched the SAM frame's kernel {d_sf} times")
            if segs[-1] < 1 or not np.isfinite(kf["logdepth_perseg"]).all():
                fail(f"real-net keyframe {i}: {segs[-1]} segments or non-finite log-depths")
            if d_k3 != 2 or d_k2 == 0:
                fail(f"real-net keyframe {i} launched K3 {d_k3} and K2 {d_k2} times")
        supp = fe.process_to_supp_kf(ds[2]["image"], ds[2]["intrinsics"])
        if not np.isfinite(supp["image"]).all():
            fail("the real-net supporting frame is not finite")
        kf_stages = {k: round(v, 4) for k, v in fe.timer.totals.items()}
        fe.timer = None  # the odometry's own StageTimer takes the frontend's stages
        t0 = time.perf_counter()
        r = run_odometry(cfg, fe, ds, max_frames=REAL_NET_FRAMES, device="cuda")
        vo_s = time.perf_counter() - t0
        launches = launch_counts()
    odom = r["odom"]
    est = dict(odom.global_track_trajectory)
    finite = all(np.isfinite(np.asarray(T)).all() for T in est.values())
    if odom.num_kfs < 1 or len(est) != REAL_NET_FRAMES - 1 or not finite:
        fail(f"the real-net VO run: {odom.num_kfs} keyframes, {len(est)} tracked poses, "
             f"finite {finite}")
    ate = ate_rmse({ts: np.asarray(ds.poses[int(ts)], np.float32) for ts in est}, est,
                   align_scale=True)["rmse"]
    vo_stages = {k: round(v, 4) for k, v in odom.timer.totals.items()}
    print(f"real nets on {card}: keyframes {kf_s[0]:.2f} s (cold), {kf_s[1]:.2f} s (warm), segments "
          f"{segs}; stage seconds {json.dumps(kf_stages)}", flush=True)
    print(f"real-net VO, {REAL_NET_FRAMES} frames: {odom.num_kfs} keyframes, wall {vo_s:.2f} s, "
          f"keyframe add {[round(w, 3) for _, w, _ in odom.kf_add_log]} s, Sim(3) ATE over the "
          f"tracked frames {ate:.5f} (random weights: not gated); launches {launches}; stage "
          f"seconds {json.dumps(vo_stages)}", flush=True)
    if launches["phase_counts"] == 0 or launches["bini_cg"] == 0:
        fail("the real-net path did not launch K3 and K2")

    k2_rows = [k2_row(torch, stencil, *args) for args in k2_inputs.values()]
    k3_rows = [k3_row(torch, k3, *args) for args in k3_inputs.values()]
    sf_rows = [sam_frame_row(torch, sf, *args, predictor=predictor)
               for args in sf_inputs.values()]
    for row, args in zip(k3_rows, k3_inputs.values()):
        row["undecided_share"] = undecided_share(torch, k3, *args)
    print("K3 on the real decoder's logits: " + ", ".join(
        f"{r['shape'][0]} slabs exact, device {r['device_ms'] * 1e3:.2f} us, "
        f"{100 * r['undecided_share']:.2f}% of region pixels to the full path"
        for r in k3_rows), flush=True)

    # times, each on the card's events after a warm-up
    times = {"encoder_bf16_ms": time_ms(torch, lambda: predictor.encode(img_dev), reps=5),
             "encoder_f32_ms": time_ms(torch, lambda: p32.encode(img_dev), reps=2)}
    predictor.set_image(sam_img)
    r = np.random.default_rng(9)
    calls = {"encoder_bf16": lambda: predictor.encode(img_dev),
             "nnet": lambda: fe.normals_fn(image_u8)}
    for n in (cfg.frontend.num_pts, cfg.frontend.num_pts_active):
        pts = torch.from_numpy((r.random((n, 2)) * [h2w2[1] - 1, h2w2[0] - 1]).astype(np.float32))
        pts = pts.round().cuda()
        times[f"decode_{n}_ms"] = time_ms(torch, lambda: predictor._decode(pts), reps=3)
        calls[f"decode_select_{n}"] = lambda pts=pts: predictor._decode_select(
            pts, h2w2, 256, 0.0, 0.0)
        times[f"decode_select_{n}_ms"] = time_ms(torch, calls[f"decode_select_{n}"], reps=3)
    times["nnet_ms"] = time_ms(torch, calls["nnet"], reps=3)
    for name, fn in calls.items():
        times[f"{name}_busy_ms"], times[f"{name}_kernels"] = busy_ms(torch, fn)
        times[f"{name}_idle_share"] = 1.0 - times[f"{name}_busy_ms"] / times[f"{name}_ms"]
    times["max_memory_allocated_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    # phase 11's prompt selection: a round of this keyframe's prompts on the
    # decoder's weights and the encoder's features
    r = np.random.default_rng(10)
    pts = torch.from_numpy((r.random((cfg.frontend.num_pts, 2)) * [h2w2[1] - 1, h2w2[0] - 1])
                           .round().astype(np.float32))
    decode_inputs = {
        "state_dict": {f"{m}.{k}": v.detach().cpu() for m in ("prompt_encoder", "mask_decoder")
                       for k, v in getattr(predictor.model, m).state_dict().items()},
        "state_dict_f32": {f"{m}.{k}": v.detach().cpu()
                           for m in ("prompt_encoder", "mask_decoder")
                           for k, v in getattr(p32.model, m).state_dict().items()},
        "cfg": VIT_H, "features": predictor._features.cpu(), "input_hw": tuple(h2w2),
        "pts": pts, "out_size": 256, "compute_dtype": torch.bfloat16}
    times["phase_s"] = time.perf_counter() - t_phase
    print(f"real-net times on {card}: " + json.dumps({k: round(v, 4) for k, v in times.items()}),
          flush=True)
    summary = {"card_vs_cpu": errs, "bf16_vs_f32": errs_bf16, "keyframe_s": kf_s,
               "segments": segs,
               "keyframe_stage_s": kf_stages, "vo_frames": REAL_NET_FRAMES,
               "vo_keyframes": odom.num_kfs, "vo_wall_s": vo_s,
               "vo_kf_add_s": [w for _, w, _ in odom.kf_add_log], "vo_ate_sim3": ate,
               "vo_stage_s": vo_stages, "launches": launches, "times": times}
    return launches, k2_rows, k3_rows, sf_rows, summary, decode_inputs, weights


@contextlib.contextmanager
def slab_counts(k3):
    """While open, counts the slabs K3's wrapper is given (``n``) and its
    calls (``calls``)."""
    seen = {"n": 0, "calls": 0}
    wrapped = k3.phase_counts

    def spy(x, *rest):
        seen["n"] += int(x.shape[0])
        seen["calls"] += 1
        return wrapped(x, *rest)

    k3.phase_counts = spy
    try:
        yield seen
    finally:
        k3.phase_counts = wrapped


@contextlib.contextmanager
def stats_path_counts(predictor, k3):
    """While open, counts the calls of ``predictor.predict_points_with_stats``
    (the loose rerun's route to K3), their prompts and the K3 launches made
    inside them."""
    seen = {"calls": 0, "prompts": 0, "k3_launches": 0}
    wrapped = predictor.predict_points_with_stats

    def spy(pts, *args, **kwargs):
        before = k3.launch_counts["phase_counts"]
        out = wrapped(pts, *args, **kwargs)
        seen["calls"] += 1
        seen["prompts"] += len(pts)
        seen["k3_launches"] += k3.launch_counts["phase_counts"] - before
        return out

    predictor.predict_points_with_stats = spy
    try:
        yield seen
    finally:
        del predictor.predict_points_with_stats


def loader_config_file(pkg_dir: Path, out: Path, name: str, base: str, dataset: dict,
                       save_path: Path, **extra) -> Path:
    """A copy of the port's config ``base`` with ``dataset`` replaced, the
    GN/LM solvers for tracking and mapping and the top-level keys of
    ``extra``, written to ``out/name``."""
    import yaml

    cfg = yaml.safe_load((pkg_dir / "configs" / base).read_text())
    cfg.update(dataset=dataset, save_path=str(save_path), **extra)
    align = cfg.setdefault("alignment", {})
    align.setdefault("mapping", {})["solver"] = "gn"
    if "track" in align:
        align["track"]["solver"] = "gn"
    path = out / name
    path.write_text(yaml.safe_dump(cfg))
    return path


def run_void_real(torch, stencil, k3, pkg_dir: Path, work: Path, seq, weights: dict,
                  card: str) -> dict:
    """Phase 9a: ``evaluate_void --sam-ckpt --nnet-ckpt`` on the VOID config
    unchanged over the first images of the tree, then one more image, on
    every ``VOID_LOOSE_STRIDE``-th of its sparse points, through
    ``DepthCompletion(invalid_ratio_thresh=0.0)``, so that the loose rerun
    and with it K3's statistics path run.  The weights are phase 8's
    frontend's (``weights``, phase 8's synthetic state dicts; at a trained
    net's scale, random SAM weights leave no candidate stable at the
    config's 0.9).  Records K2's and K3's inputs; holds the SAM frame's
    kernel to its plain version on the path's first image, and times it and
    the predictor's ``prepare_frame`` there."""
    import numpy as np

    from super_primitive_tpu_torch import evaluate_void
    from super_primitive_tpu_torch.convert import nnet_to_flax, sam_to_flax, save_npz_tree
    from super_primitive_tpu_torch.data.void import VoidDataset
    from super_primitive_tpu_torch.depth_completion.completion import DepthCompletion
    from super_primitive_tpu_torch.nets.sam.image_encoder import VIT_H
    from super_primitive_tpu_torch.ops import sam_frame as sf
    from super_primitive_tpu_torch.utils.timing import StageTimer

    t0 = time.perf_counter()
    save_npz_tree(work / "sam.npz", sam_to_flax(weights["sam"], depth=VIT_H.depth))
    save_npz_tree(work / "nnet.npz", nnet_to_flax(weights["nnet"]))
    trees_s = time.perf_counter() - t0
    cfg_path = pkg_dir / "configs" / "void_dataset.yaml"
    torch.cuda.reset_peak_memory_stats()
    # every K2 call logged, the largest and the longest-running kept whole;
    # K3's first call at each slab count
    with k2_calls(torch, stencil) as k2_seen, \
            first_inputs(torch, k3, "phase_counts") as k3_inputs, slab_counts(k3) as slabs, \
            first_inputs(torch, sf, "sam_frame") as sf_inputs:
        reset_launch_counts()
        t0 = time.perf_counter()
        res = evaluate_void.main(["--dataset", str(work / "void"), "--config", str(cfg_path),
                                  "--sam-ckpt", str(work / "sam.npz"),
                                  "--nnet-ckpt", str(work / "nnet.npz"),
                                  "--max-images", str(VOID_IMAGES)])
        cli_s = time.perf_counter() - t0
        cli = {"launches": launch_counts(),
               "k3_slabs": slabs["n"], "peak_GiB": torch.cuda.max_memory_allocated() / 2**30}
        fe = res["completion"].frontend
        sample = VoidDataset(str(work / "void"))[VOID_IMAGES]
        sparse = np.asarray(sample["sparse_depth"], np.float32).copy()
        rows, cols = np.nonzero(sparse > 1e-6)
        drop = np.ones(len(rows), bool)
        drop[::VOID_LOOSE_STRIDE] = False
        sparse[rows[drop], cols[drop]] = 0.0
        dc = DepthCompletion(fe, invalid_ratio_thresh=0.0)
        fe.timer = dc.timer = StageTimer("cuda")
        before = launch_counts()
        slabs0 = slabs["n"]
        torch.cuda.reset_peak_memory_stats()
        with stats_path_counts(fe.mask_predict_fn.predictor, k3) as stats:
            t0 = time.perf_counter()
            depths, invalid = dc.depth_completion(sample["image"], sample["intrinsics"], sparse)
            torch.cuda.synchronize()
            loose_s = time.perf_counter() - t0
        launches = launch_counts()
    loose = {"wall_s": loose_s, "sparse_points": int((sparse > 1e-6).sum()),
             "segments": list(dc.segments),
             "stage_s": {k: round(v, 4) for k, v in fe.timer.totals.items()},
             "launches": {k: launches[k] - before[k] for k in launches},
             "k3_slabs": slabs["n"] - slabs0, "stats_path": stats,
             "validity_rate": float((depths > 1e-6).mean()),
             "peak_GiB": torch.cuda.max_memory_allocated() / 2**30}
    sf_rows = [sam_frame_row(torch, sf, *args, predictor=fe.mask_predict_fn.predictor)
               for args in sf_inputs.values()]
    for name, run in (("evaluate_void", cli), ("loose image", loose)):
        print(f"VOID real nets on {card}, {name}: launches {run['launches']}, K3 slabs "
              f"{run['k3_slabs']}, peak memory {run['peak_GiB']:.2f} GiB", flush=True)
    print(f"VOID real nets, loose image: wall {loose_s:.2f} s, {loose['sparse_points']} sparse "
          f"points, (segments, visible) per pass "
          f"{dc.segments}, statistics path {stats}, "
          f"validity {loose['validity_rate']:.3f}, stage seconds {json.dumps(loose['stage_s'])}",
          flush=True)
    if launches["bini_apply"] != 0:
        fail("the VOID path launched K1")
    if cli["launches"]["bini_cg"] == 0 or cli["launches"]["phase_counts"] == 0:
        fail("evaluate_void on the real nets did not launch K2 and K3")
    if cli["launches"]["sam_frame"] == 0 or loose["launches"]["sam_frame"] == 0:
        fail("the VOID path did not make SAM's frame on the card")
    if stats["calls"] == 0 or stats["k3_launches"] == 0:
        fail("the loose rerun did not take K3's statistics path")
    if not (np.isfinite(depths).all() and (depths[~invalid] > 0).all()):
        fail("the loose completion is not finite and positive where valid")
    log = k2_seen["log"]
    for call in log:
        if not stencil.cg_holds(*call["shape"][1:]):
            fail(f"a VOID K2 field {call['shape']} holds no K2 plan")
    k2_log = {"calls": len(log), "segments": sorted({c["shape"][0] for c in log}),
              "max_iter": sorted({c["max_iter"] for c in log}),
              "tol": sorted({c["tol"] for c in log}),
              "iters": sum(c["iters"] for c in log),
              "longest": max((c["longest"] for c in log), default=0),
              "calls_at_max_iter": sum(c["longest"] >= c["max_iter"] for c in log)}
    print(f"K2 on the VOID path: {json.dumps(k2_log)}", flush=True)
    summary = {"images": res["images"], "tables": res["tables"],
               "validity_rates": res["validity_rates"],
               "evaluate_void_s": cli_s, "trees_s": trees_s, "evaluate_void": cli,
               "loose_image": loose, "k2_calls": k2_log}
    recorded = {"bini_cg": k2_seen["kept"], "phase_counts": list(k3_inputs.values()),
                "sam_frame_rows": sf_rows}
    return summary, recorded


def run_void_fake(torch, stencil, k3, pkg_dir: Path, work: Path, seq) -> dict:
    """Phase 9b: the structured fake (exact plane normals, the device SAM
    selection) completes the same images through ``DepthCompletion``; gated
    on the valid-only AbsRel against ground truth and the validity rate."""
    import numpy as np

    from super_primitive_tpu_torch.config import load_config
    from super_primitive_tpu_torch.data.void import VoidDataset
    from super_primitive_tpu_torch.depth_completion import metrics as M
    from super_primitive_tpu_torch.depth_completion.completion import DepthCompletion
    from super_primitive_tpu_torch.frontend.fakes import StructuredFakeFrontend

    cfg = load_config(str(pkg_dir / "configs" / "void_dataset.yaml"))
    fe = StructuredFakeFrontend(cfg, scene=seq.scene, n_cells=64, device="cuda",
                                device_sam=True)
    dc = DepthCompletion(fe)
    ds = VoidDataset(str(work / "void"))
    rows = []
    reset_launch_counts()
    for i in range(VOID_IMAGES):
        s = ds[i]
        fe.observe(seq[i])
        t0 = time.perf_counter()
        depths, invalid = dc.depth_completion(s["image"], s["intrinsics"], s["sparse_depth"])
        wall = time.perf_counter() - t0
        m = M.ErrorMetrics()
        m.compute(depths, s["gt_depth"], (depths > 1e-6) & s["gt_valid"])
        rows.append({"absrel": float(m.absrel), "rmse_mm": float(m.rmse), "segments": dc.segments,
                     "validity_rate": float((depths > 1e-6).mean()), "wall_s": wall})
    launches = launch_counts()
    print(f"VOID structured fake: {json.dumps(rows)}; launches {launches}; bounds AbsRel <= "
          f"{VOID_FAKE_ABSREL}, validity >= {VOID_FAKE_VALIDITY}", flush=True)
    if launches["bini_cg"] == 0 or launches["phase_counts"] == 0:
        fail("the structured-fake VOID run did not launch K2 and K3")
    for r in rows:
        if not (r["absrel"] <= VOID_FAKE_ABSREL and r["validity_rate"] >= VOID_FAKE_VALIDITY):
            fail(f"the structured-fake completion misses its bounds: {r}")
    return {"images": rows, "launches": launches}


def run_loaders(torch, stencil, k3, pkg_dir: Path, work: Path, seq, card: str) -> dict:
    """Phase 9c: TUM and Replica trees decode to the arrays written; a
    ``run_sfm --odom --fake-frontend --live-viz`` over the TUM tree and
    ``convert_traj_to_tum`` on its run, a ``tum_undistort`` read of it, and
    a two-frame ``run_sfm --fake-frontend`` on the Replica tree, each
    ending finite with its artifacts; decode ms per 480x640 frame."""
    import numpy as np
    import yaml

    from super_primitive_tpu_torch import run_sfm
    from super_primitive_tpu_torch.data.image_io import read_png, read_rgb
    from super_primitive_tpu_torch.data.replica import ReplicaDataset
    from super_primitive_tpu_torch.data.transforms import scale_and_filter_depth
    from super_primitive_tpu_torch.data.tum import (
        DEPTH_SCALE,
        MAX_DEPTH,
        TUMDataset,
        TUMUndistortDataset,
    )
    from super_primitive_tpu_torch.eval.dataset_trees import (
        depth_u16,
        image_u8,
        write_replica_tree,
        write_tum_tree,
    )

    K = [float(v) for v in (seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])]
    tum = write_tum_tree(work / "tum", seq, TUM_FRAMES)
    replica = write_replica_tree(work / "replica", seq, REPLICA_FRAMES)
    ds = TUMDataset(str(tum), traj_file=str(tum / "groundtruth.txt"), intrinsics=K)
    rgb_ms, depth_ms = [], []
    for i in range(TUM_FRAMES):
        t0 = time.perf_counter()
        img = read_rgb(str(tum / ds.rgb_files[i]))
        t1 = time.perf_counter()
        dep = read_png(str(tum / ds.depth_files[i]))
        t2 = time.perf_counter()
        rgb_ms.append((t1 - t0) * 1e3)
        depth_ms.append((t2 - t1) * 1e3)
        f = ds[i]
        if not (np.array_equal(img, image_u8(seq[i])) and np.array_equal(f["image"], img)
                and np.array_equal(dep, depth_u16(seq[i]["depth"], 5000.0))
                and np.array_equal(f["depth"], scale_and_filter_depth(dep, DEPTH_SCALE,
                                                                      MAX_DEPTH))):
            fail(f"TUM frame {i} does not decode to the arrays written")
    und = TUMUndistortDataset(str(tum), traj_file=str(tum / "groundtruth.txt"))
    for i in range(TUM_FRAMES):
        f = und[i]
        want = scale_and_filter_depth(depth_u16(seq[i]["depth"], 5000.0)[16:-16, 32:-32],
                                      DEPTH_SCALE, MAX_DEPTH)
        if f["image"].shape != (448, 576, 3) or not np.array_equal(f["depth"], want):
            fail(f"tum_undistort frame {i}: image {f['image'].shape} or its depth crop differs")
    rep = ReplicaDataset(str(replica), intrinsics=K)
    for i in range(REPLICA_FRAMES):
        f = rep[i]
        if not (np.array_equal(f["image"], image_u8(seq[i]))
                and np.array_equal(read_png(str(replica / "depth" / f"depth_{i}.png")),
                                   depth_u16(seq[i]["depth"], 1000.0))
                and np.allclose(f["T"], seq[i]["T"], atol=1e-6)):
            fail(f"Replica frame {i} does not decode to the arrays written")

    odom_cfg = loader_config_file(
        pkg_dir, work, "tum_odom.yaml", "planes_odom.yaml",
        {"type": "tum", "path": str(tum), "traj_file": str(tum / "groundtruth.txt"),
         "intrinsics": K}, work / "tum_out",
        kf={**yaml.safe_load((pkg_dir / "configs" / "planes_odom.yaml").read_text())["kf"],
            "translation_thresh": TUM_KF_TRANSLATION})
    sfm_cfg = loader_config_file(
        pkg_dir, work, "replica_sfm.yaml", "planes_sfm.yaml",
        {"type": "replica", "path": str(replica), "intrinsics": K, "source_id": 0,
         "target_id": 4}, work / "replica_out")
    reset_launch_counts()
    t0 = time.perf_counter()
    live = work / "tum_live"
    run_sfm.main(["--config", str(odom_cfg), "--odom", "--fake-frontend",
                  "--max-frames", str(TUM_FRAMES), "--live-viz", str(live)])
    odom_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_sfm.main(["--config", str(sfm_cfg), "--fake-frontend"])
    sfm_s = time.perf_counter() - t0
    launches = launch_counts()
    tum_out, rep_out = work / "tum_out", work / "replica_out"
    traj = np.loadtxt(tum_out / "converted_tum_traj.txt", ndmin=2)
    result = np.load(rep_out / "two_frame_result.npz")
    finite = bool(np.isfinite(traj).all() and np.isfinite(result["pose"]).all()
                  and np.isfinite(result["kp_logdepth"]).all())
    # the artifacts: what run_sfm left, then the TUM files written again by
    # convert_traj_to_tum in a process of its own
    missing = [str(p) for p in (tum_out / "viewer.html", tum_out / "trajectory.png",
                                tum_out / "converted_gt_tum_traj.txt", live / "live.json",
                                live / "live.html", rep_out / "src_pointcloud.ply",
                                rep_out / "viewer.html") if not p.exists()]
    if missing:
        fail(f"run_sfm left no {', '.join(missing)}")
    plot = read_png(str(tum_out / "trajectory.png"))
    snapshot = json.loads((live / "live.json").read_text())
    if snapshot["seq"] != TUM_FRAMES - 1:
        fail(f"live.json's seq is {snapshot['seq']}, not the {TUM_FRAMES - 1} tracked frames")
    tum_files = {n: (tum_out / n).read_text()
                 for n in ("converted_tum_traj.txt", "converted_gt_tum_traj.txt")}
    for n in tum_files:
        (tum_out / n).unlink()
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "super_primitive_tpu_torch.convert_traj_to_tum",
                    "--run", str(tum_out), "--config", str(odom_cfg)], check=True,
                   timeout=300, cwd=pkg_dir.parent)
    convert_s = time.perf_counter() - t0
    for n, text in tum_files.items():
        if not (tum_out / n).exists() or (tum_out / n).read_text() != text:
            fail(f"convert_traj_to_tum did not write {n} as run_sfm did")
    out = {"rgb_decode_ms": rgb_ms, "depth_decode_ms": depth_ms,
           "rgb_decode_ms_mean": float(np.mean(rgb_ms[1:])),
           "depth_decode_ms_mean": float(np.mean(depth_ms[1:])),
           "tum_odom_s": odom_s, "tum_keyframes": int(traj.shape[0]),
           "replica_two_frame_s": sfm_s, "convert_traj_to_tum_s": convert_s,
           "trajectory_png": list(plot.shape), "live_seq": snapshot["seq"],
           "viewer_html_bytes": (tum_out / "viewer.html").stat().st_size,
           "live_json_bytes": (live / "live.json").stat().st_size,
           "launches": launches, "finite": finite}
    print(f"loaders on {card}: decode ms per 480x640 frame, RGB "
          f"{out['rgb_decode_ms_mean']:.1f}, 16-bit depth {out['depth_decode_ms_mean']:.1f} "
          f"(first frames {rgb_ms[0]:.1f} / {depth_ms[0]:.1f}); TUM odometry with --live-viz "
          f"{odom_s:.2f} s, {traj.shape[0]} keyframes, live seq {snapshot['seq']}; "
          f"convert_traj_to_tum {convert_s:.2f} s; Replica two-frame {sfm_s:.2f} s; "
          f"launches {launches}", flush=True)
    if not finite:
        fail("the TUM odometry or the Replica two-frame run ended non-finite")
    return out


def run_void(torch, stencil, k3, pkg_dir: Path, weights: dict, card: str):
    """Phase 9: VOID depth completion at full width (9a real nets, 9b the
    structured fake) and the TUM, Replica and VOID loaders (9c); then K2
    against its plain version on slices of the VOID path's largest and
    longest-running calls, timed on each whole call, and K3, timed, on the
    path's first call at each slab count; the SAM frame's rows from 9a."""
    import shutil

    from super_primitive_tpu_torch.data.synthetic import PlanesSequence
    from super_primitive_tpu_torch.eval.dataset_trees import write_void_tree

    t_phase = time.perf_counter()
    work = Path("build") / "chip_smoke" / "void"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    seq = PlanesSequence(n_frames=max(TUM_FRAMES, REPLICA_FRAMES, VOID_IMAGES + 1), H=480,
                         W=640)
    write_void_tree(work / "void", seq, VOID_IMAGES + 1, n_sparse=VOID_SPARSE, seed=VOID_SEED)
    real, recorded = run_void_real(torch, stencil, k3, pkg_dir, work, seq, weights, card)
    torch.cuda.empty_cache()
    k2_rows = [k2_void_row(torch, stencil, args, label) for label, args in recorded["bini_cg"]]
    k3_rows = [k3_row(torch, k3, *args) for args in recorded["phase_counts"]]
    for row, args in zip(k3_rows, recorded["phase_counts"]):
        row["undecided_share"] = undecided_share(torch, k3, *args)
    sf_rows = recorded["sam_frame_rows"]
    del recorded
    torch.cuda.empty_cache()
    fake = run_void_fake(torch, stencil, k3, pkg_dir, work, seq)
    loaders = run_loaders(torch, stencil, k3, pkg_dir, work, seq, card)
    shutil.rmtree(work, ignore_errors=True)
    launches = {k: real["evaluate_void"]["launches"][k] + real["loose_image"]["launches"][k]
                for k in real["evaluate_void"]["launches"]}
    summary = {"real_nets": real, "structured_fake": fake, "loaders": loaders,
               "phase_s": time.perf_counter() - t_phase}
    print(f"VOID phase on {card}: {summary['phase_s']:.1f} s; K3 on the VOID path's inputs: "
          + ", ".join(f"{r['shape'][0]} slabs exact, device {r['device_ms'] * 1e3:.2f} us, "
                      f"{100 * r['undecided_share']:.2f}% to the full path" for r in k3_rows),
          flush=True)
    return launches, k2_rows, k3_rows, sf_rows, summary


def host_window(kfs, window_size: int, supp_cap: int, seg_cap: int, point_cap: int) -> dict:
    """The window fields that ``kfs`` (host keyframes, in slot order) should
    give, built on the host with ``build_bundle_np`` and numpy."""
    import numpy as np

    from super_primitive_tpu_torch.keyframe import build_bundle_np

    H, W, C = kfs[0].image.shape
    w = {"images": np.zeros((window_size, H, W, C), np.float32),
         "K": np.tile(np.eye(3, dtype=np.float32), (window_size, 1, 1)),
         "poses": np.tile(np.eye(4, dtype=np.float32), (window_size, 1, 1)),
         "kp_logdepth": np.zeros((window_size, seg_cap), np.float32),
         "affine": np.zeros((window_size, 2), np.float32),
         "kf_valid": np.zeros(window_size, bool),
         "uv": np.zeros((window_size, point_cap, 2), np.float32),
         "seg_id": np.zeros((window_size, point_cap), np.int64),
         "base_logdepth": np.zeros((window_size, point_cap), np.float32),
         "point_valid": np.zeros((window_size, point_cap), bool),
         "num_valid": np.zeros(window_size, np.int64),
         "kp_base": np.zeros((window_size, seg_cap), np.float32)}
    for i, kf in enumerate(kfs):
        n = kf.regions.shape[0]
        b = build_bundle_np(kf.regions, kf.logdepth_perseg, capacity=point_cap, device="cpu")
        w["images"][i], w["K"][i], w["poses"][i] = kf.image, kf.K, kf.pose
        w["kp_logdepth"][i, :n], w["affine"][i], w["kf_valid"][i] = kf.kp_logdepth, kf.affine, True
        w["uv"][i], w["seg_id"][i] = b.uv.numpy(), b.seg_id.numpy()
        w["base_logdepth"][i], w["point_valid"][i] = b.base_logdepth.numpy(), b.valid.numpy()
        w["num_valid"][i] = b.num_valid
        w["kp_base"][i, :n] = kf.logdepth_perseg[np.arange(n), kf.keypoints_rc[:, 0],
                                                 kf.keypoints_rc[:, 1]]
    return w


def window_mismatch(buffers, want: dict) -> list[str]:
    """The ``RESUME_WINDOW_FIELDS`` of ``buffers`` that are not bit for bit
    ``want``'s (dtype, shape and values)."""
    import numpy as np

    bad = []
    for f in RESUME_WINDOW_FIELDS:
        x = getattr(buffers, f)
        got = x if isinstance(x, np.ndarray) else x.cpu().numpy()
        if got.dtype != want[f].dtype or not np.array_equal(got, want[f]):
            bad.append(f)
    return bad


def run_resume(torch, stencil, k3, card: str) -> tuple[dict, dict]:
    """Phase 10: the GN VO run at full width split at ``RESUME_SPLIT``,
    checkpointed and resumed in a fresh ``Odometry`` and frontend; launch
    counts and recorded kernel inputs restart at the restore.  Then the
    checkpoint is loaded again on the card and on the CPU and held to the
    window built on the host from its keyframes, and K2 and K3 to their
    plain versions on the second leg's inputs."""
    import dataclasses
    import shutil
    import types

    import numpy as np

    from super_primitive_tpu_torch.config.schema import RestoreConfig
    from super_primitive_tpu_torch.eval.e2e_synthetic import make_e2e_config, run_e2e
    from super_primitive_tpu_torch.odometry import io
    from super_primitive_tpu_torch.odometry.odometry import Odometry

    t_phase = time.perf_counter()
    save_path = Path("build") / "chip_smoke" / "resume"
    shutil.rmtree(save_path, ignore_errors=True)
    with first_inputs(torch, stencil, "bini_cg") as k2_inputs, \
            first_inputs(torch, k3, "phase_counts") as k3_inputs:
        def at_restore():
            reset_launch_counts()
            k2_inputs.clear()
            k3_inputs.clear()

        r = run_e2e("gn", frames=RESUME_FRAMES, device="cuda", save_path=str(save_path),
                    restore_split=RESUME_SPLIT, save_every=RESUME_SAVE_EVERY,
                    on_restore=at_restore)
        launches = launch_counts()
    first, odom = r["first_leg"], r["odom"]

    def ms_per_tracked(timer):
        n = timer.counts.get("fused_frame", 0) + timer.counts.get("track", 0)
        s_ = timer.totals.get("fused_frame", 0.0) + timer.totals.get("track", 0.0)
        return 1000 * s_ / max(n, 1)

    # the checkpoint loaded again, on the card and on the CPU, against the
    # window its saved keyframes give on the host
    tag_id = RESUME_SPLIT - 1
    cfg = dataclasses.replace(make_e2e_config("gn", save_path=str(save_path)),
                              restore=RestoreConfig(path=str(save_path), frame_id=tag_id))
    kf_dir = save_path / "curr_kfs" / Odometry.id_to_timestamp(tag_id)
    saved = [io.load_kf(str(kf_dir), ts) for ts in (kf_dir / "window.txt").read_text().split()]
    loaded = {}
    for dev in ("cuda", "cpu"):
        o = Odometry(cfg, types.SimpleNamespace(), None, device=dev)
        o.load_state(str(save_path), tag_id)
        loaded[dev] = o
    o = loaded["cuda"]
    want = host_window(saved, o.window_size, o.supp_cap, o.seg_cap, o.point_cap)
    card_bad = window_mismatch(o.buffers, want)
    cpu_bad = window_mismatch(loaded["cpu"].buffers, want)
    caps = (o.seg_cap, o.point_cap) == (first.seg_cap, first.point_cap)
    del loaded, o

    ate = r["ate"]["rmse"]
    finite = all(np.isfinite(np.asarray(T)).all() for T in odom.global_track_trajectory.values())
    recorded = {"bini_cg": list(k2_inputs.values()), "phase_counts": list(k3_inputs.values())}
    summary = {
        "frames": r["frames"], "split": RESUME_SPLIT, "save_every": RESUME_SAVE_EVERY,
        "save_state_s": r["save_s"], "checkpoint_bytes": r["checkpoint_bytes"],
        "load_state_s": r["load_s"],
        "ms_per_tracked_frame": {"before": ms_per_tracked(first.timer),
                                 "after": ms_per_tracked(odom.timer)},
        "tracked": {"before": r["pre_restore_tracked"], "after": r["post_restore_tracked"]},
        "keyframes_added": {"before": len(first.kf_add_log), "after": len(odom.kf_add_log)},
        "keyframes": r["keyframes"], "window_kfs_restored": len(saved),
        "capacities": [first.seg_cap, first.point_cap], "ate_sim3": ate, "wall_s": r["wall_s"],
        "launches_after_restore": launches, "window_card_mismatch": card_bad,
        "window_cpu_mismatch": cpu_bad}
    print(f"resume slice on {card}: split at {RESUME_SPLIT} of {r['frames']} frames; save_state "
          f"{r['save_s']:.3f} s, {r['checkpoint_bytes']} bytes; load_state {r['load_s']:.3f} s; "
          f"ms per tracked frame {summary['ms_per_tracked_frame']['before']:.1f} before, "
          f"{summary['ms_per_tracked_frame']['after']:.1f} after; keyframes added "
          f"{summary['keyframes_added']}; Sim(3) ATE {ate:.5f}; launches after the restore "
          f"{launches}", flush=True)
    if launches["bini_cg"] == 0 or launches["phase_counts"] == 0:
        fail("the resumed leg did not launch K2 and K3")
    if not odom.kf_add_log:
        fail("the resumed leg added no keyframe")
    if card_bad or cpu_bad or not caps:
        fail(f"the restored window differs from the saved keyframes: card {card_bad}, cpu "
             f"{cpu_bad}, capacities kept {caps}")
    if not finite:
        fail("the resumed run has a non-finite pose")
    if not (math.isfinite(ate) and ate < 0.05):
        fail(f"the resumed run's Sim(3) ATE {ate} is not below 0.05")
    summary["kernel_checks"] = check_new_inputs(
        torch, stencil, k3, recorded, {"bini_cg": [], "phase_counts": []})
    print("kernels on the resumed leg's inputs: " + json.dumps(summary["kernel_checks"]),
          flush=True)
    summary["phase_s"] = time.perf_counter() - t_phase
    return launches, summary


def sharded_rank(mesh, jobs, checks):
    """One rank of phase 11b: ``jobs`` with K2's and K3's launch counts
    reset just before and read just after, and a copy of each kernel's
    first inputs at every shape; then ``jobs`` again, timed; then
    ``checks`` (not counted)."""
    import torch

    from super_primitive_tpu_torch.ops import phase_counts as k3
    from super_primitive_tpu_torch.ops import stencil
    from super_primitive_tpu_torch.parallel.dryrun import run_flows

    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    with first_inputs(torch, stencil, "bini_cg") as k2_inputs, \
            first_inputs(torch, k3, "phase_counts") as k3_inputs:
        reset_launch_counts()
        outs = run_flows(mesh, jobs)
        launches = launch_counts()
    warm = [o["seconds"] for o in run_flows(mesh, jobs)]
    return {"outs": outs, "warm_s": warm, "checks": run_flows(mesh, checks),
            "launches": launches, "recorded": {"bini_cg": list(k2_inputs.values()),
                                               "phase_counts": list(k3_inputs.values())},
            "peak_GiB": torch.cuda.max_memory_allocated(mesh.device) / 2**30 if on_card else None}


def max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def run_sharded(torch, stencil, k3, gn: dict, bini_calls: dict, decode: dict, card: str):
    """Phase 11: (a) ``dryrun_multichip(1)`` over NCCL; (b) the full-width
    sharded flows on two gloo ranks on this card against the same flows
    unsharded in this process; then K2 and K3 against their plain versions
    on the ranks' recorded inputs."""
    from super_primitive_tpu_torch.parallel import dryrun, launch

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(1, device="cuda")[0]
    dry_s = time.perf_counter() - t0
    if dry["mesh"] != {"dp": 1, "sp": 1} or not dry["replicated"]:
        fail(f"dryrun_multichip(1) over NCCL: {dry}")

    opts = gn["options"]
    win = dict(buffers=gn["buffers"], slots=gn["slots"], masks=gn["masks"],
               geo_dims=gn["geo_dims"])
    names = ["assemble", "gn_mapping"] + [f"bini_{c}" for c in sorted(bini_calls)] + ["decode"]
    jobs = ([("assemble", dict(win, use_affine=opts.get("use_affine", False),
                               point_stride=opts.get("point_stride", 1))),
             # the LM budget of the JAX package's sharded test, whose bounds
             # these are (5 iterations, no early stop): over a longer solve
             # the damping path parts on float32 noise
             ("gn_mapping", dict(win, **{**opts, "max_iters": 5, "tol": 0.0}))]
            + [("bini", bini_calls[c]) for c in sorted(bini_calls)]
            + [("decode", dict(decode, counts=False))])
    checks = [("decode", dict(decode, counts=True))]
    t0 = time.perf_counter()
    ranks = launch.run(sharded_rank, 2, "gloo", "cuda", args=(jobs, checks), timeout=300,
                       deadline=600)
    ranks_s = time.perf_counter() - t0
    with first_inputs(torch, stencil, "bini_cg") as plain_k2:
        plain = dryrun.run_flows(None, jobs, device="cuda")
    plain_warm = [o["seconds"] for o in dryrun.run_flows(None, jobs, device="cuda")]
    plain_check = dryrun.run_flows(None, checks, device="cuda")[0]

    flows = {}
    for i, name in enumerate(names):
        got, want = ranks[0]["outs"][i], plain[i]
        row = {"sharded_s": max(r["warm_s"][i] for r in ranks), "unsharded_s": plain_warm[i],
               "sharded_cold_s": max(r["outs"][i]["seconds"] for r in ranks),
               "replicated": all(r["outs"][i]["replicated"] for r in ranks)}
        if name == "assemble":
            errs = {}
            for key, a, b in zip(("H", "g_t", "D", "gl", "Bs", "cost"), got["lin"], want["lin"]):
                b = b.cpu()
                atol = SHARD_TOL["H"] if key == "H" else SHARD_TOL["assemble"]
                excess = float(((a - b).abs() - atol - SHARD_TOL["assemble_rel"] * b.abs()).max())
                errs[key] = {"max_abs": max_diff(a, b), "within": excess <= 0}
            row["errors"] = errs
            ok = all(e["within"] for e in errs.values())
        elif name == "gn_mapping":
            pose = max_diff(got["poses"], want["poses"].cpu())
            cost = abs(float(got["final_cost"]) / float(want["final_cost"]) - 1)
            row.update(pose_max_abs=pose, final_cost_rel=cost,
                       final_cost=[float(got["final_cost"]), float(want["final_cost"])],
                       iters=[got["num_iters"], want["num_iters"]],
                       iters_by_rank=[r["outs"][i]["num_iters"] for r in ranks])
            ok = (pose <= SHARD_TOL["gn_pose"] and cost <= SHARD_TOL["gn_cost_rel"]
                  and len(set(row["iters_by_rank"])) == 1)
        elif name.startswith("bini"):
            zt = [max_diff(a, b.cpu()) for a, b in zip(got["out"], want["out"])]
            row.update(segments=int(got["out"][0].shape[0]), max_abs=zt[0],
                       bit_identical=all(torch.equal(a, b.cpu())
                                         for a, b in zip(got["out"], want["out"])))
            ok = zt[0] <= SHARD_TOL["bini"] and all(e == 0 for e in zt[1:])
        else:
            exact = {k: bool(torch.equal(got[k], want[k].cpu())) for k in ("packed", "valid",
                                                                            "pick")}
            counts = bool(torch.equal(ranks[0]["checks"][0]["counts"],
                                      plain_check["counts"].cpu()))
            errs = {k: max_diff(got[k], want[k].cpu()) for k in ("iou", "boxes")}
            row.update(prompts=int(got["pick"].shape[0]), exact=exact, k3_counts_exact=counts,
                       max_abs=errs)
            ok = all(exact.values()) and counts and max(errs.values()) <= SHARD_TOL["decode"]
        flows[name] = row
        if not (ok and row["replicated"]):
            fail(f"phase 11b's sharded {name} against unsharded: {json.dumps(row)}")

    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    by_rank = [r["launches"] for r in ranks]
    if any(r["bini_cg"] == 0 or r["phase_counts"] == 0 for r in by_rank):
        fail(f"a rank of the sharded path did not launch K2 and K3: {by_rank}")
    recorded = {name: [[a.cuda() if torch.is_tensor(a) else a for a in args]
                       for r in ranks for args in r["recorded"][name]]
                for name in ("bini_cg", "phase_counts")}
    k2_rows = [k2_row(torch, stencil, *args) for args in recorded["bini_cg"]]
    k3_rows = [k3_row(torch, k3, *args) for args in recorded["phase_counts"]]
    # is K2 batch-invariant?  A rank's first K2 call at each crop against
    # the unsharded first call on the whole batch, on the rank's rows
    k2_batch = []
    for rank, rec in enumerate(ranks):
        for args in rec["recorded"]["bini_cg"]:
            n, H, W = args[0].shape
            full = next(a for shape, a in plain_k2.items() if shape[1:] == (H, W))
            lo = rank * n
            m = min(n, full[0].shape[0] - lo)
            mine = [a.cuda() if torch.is_tensor(a) else a for a in args]
            same_in = all(torch.equal(a[:m], b[lo:lo + m]) for a, b in zip(mine, full)
                          if torch.is_tensor(a))
            (x_r, it_r), (x_f, it_f) = stencil.bini_cg(*mine), stencil.bini_cg(*full)
            k2_batch.append({"field": [H, W], "rank": rank, "rows": m, "inputs_equal": same_in,
                             "outputs_equal": bool(torch.equal(x_r[:m], x_f[lo:lo + m])
                                                   and torch.equal(it_r[:m], it_f[lo:lo + m]))})
    summary = {"dryrun_nccl_world1": dry, "dryrun_s": dry_s, "ranks_s": ranks_s,
               "k2_batch_invariance": k2_batch,
               "window": {"keyframes": gn["keyframes"], "geo_dims": list(gn["geo_dims"]),
                          "point_capacity": int(gn["buffers"].uv.shape[1]),
                          "points": [int(n) for n in gn["buffers"].num_valid]},
               "flows": flows, "launches": launches, "launches_by_rank": by_rank,
               "peak_GiB_by_rank": [r["peak_GiB"] for r in ranks],
               "phase_s": time.perf_counter() - t_phase}
    print(f"sharded flows on {card} (2 gloo ranks on one card: not a scaling measurement): "
          + json.dumps(summary), flush=True)
    return launches, k2_rows, k3_rows, summary


@contextlib.contextmanager
def read_waits(dataset):
    """While open, the wall time of each of ``dataset``'s image reads (its
    ``_read_pair``: the native loader's wait, or ``image_io``'s decode) is
    appended, in ms, to the yielded list."""
    waits = []
    wrapped = dataset._read_pair

    def timed(idx):
        t0 = time.perf_counter()
        out = wrapped(idx)
        waits.append((time.perf_counter() - t0) * 1e3)
        return out

    dataset._read_pair = timed
    try:
        yield waits
    finally:
        del dataset._read_pair


def run_native_loader(torch, stencil, k3, pkg_dir: Path, work: Path, card: str):
    """Phase 12a: the native loader on a copy of phase 9c's TUM tree (exact
    PNG decodes, the undistort on its decode threads, a JPEG or the missing
    header named), decode times, and ``run_sfm --odom --fake-frontend`` with
    the loader and with ``image_io``."""
    import numpy as np
    import yaml

    from super_primitive_tpu_torch.config import load_config
    from super_primitive_tpu_torch.data import native_loader
    from super_primitive_tpu_torch.data.image_io import read_png, read_rgb, write_jpeg
    from super_primitive_tpu_torch.data.synthetic import PlanesSequence
    from super_primitive_tpu_torch.data.tum import TUMDataset, TUMUndistortDataset
    from super_primitive_tpu_torch.eval.dataset_trees import image_u8, write_tum_tree
    from super_primitive_tpu_torch.eval.trajectory import ate_rmse
    from super_primitive_tpu_torch.frontend.fakes import StructuredFakeFrontend
    from super_primitive_tpu_torch.odometry.odometry import Odometry

    t0 = time.perf_counter()
    built = native_loader.build()
    build_s = time.perf_counter() - t0
    has_jpeg = native_loader.has_jpeg()
    seq = PlanesSequence(n_frames=max(TUM_FRAMES, REPLICA_FRAMES, VOID_IMAGES + 1), H=480,
                         W=640)
    tum = write_tum_tree(work / "tum", seq, TUM_FRAMES)
    K = [float(v) for v in (seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])]
    traj = str(tum / "groundtruth.txt")
    plain = TUMDataset(str(tum), traj_file=traj, intrinsics=K, native=False)
    rgb_paths = [str(tum / f) for f in plain.rgb_files]
    depth_paths = [str(tum / f) for f in plain.depth_files]
    io_ms = []
    for i in range(TUM_FRAMES):
        t0 = time.perf_counter()
        want = (read_rgb(rgb_paths[i]), read_png(depth_paths[i]))
        io_ms.append((time.perf_counter() - t0) * 1e3)
    with native_loader.NativeImageLoader(rgb_paths) as rgb, \
            native_loader.NativeImageLoader(depth_paths) as depth:
        wait_ms = []
        for i in range(TUM_FRAMES):
            t0 = time.perf_counter()
            got = (rgb.rgb(i), depth[i])
            wait_ms.append((time.perf_counter() - t0) * 1e3)
            if not (np.array_equal(got[0], read_rgb(rgb_paths[i]))
                    and np.array_equal(got[1], read_png(depth_paths[i]))
                    and np.array_equal(got[0], image_u8(seq[i]))):
                fail(f"the native loader's frame {i} differs from image_io's")
            time.sleep(0.05)  # the consumer's work, while the next frames decode
    und_native = TUMUndistortDataset(str(tum), traj_file=traj)
    und_plain = TUMUndistortDataset(str(tum), traj_file=traj, native=False)
    und_diff = max(int(np.abs(und_native[i]["image"].astype(int)
                              - und_plain[i]["image"].astype(int)).max())
                   for i in range(TUM_FRAMES))
    if und_diff > 2:
        fail(f"the undistort on the decode threads differs from remap_bilinear by {und_diff}")
    yy, xx = np.mgrid[:480, :640]
    gray = np.clip(128 + 60 * np.sin(xx / 17.0) + 40 * np.cos(yy / 23.0), 0, 255).astype(np.uint8)
    write_jpeg(work / "gray.jpg", gray)
    with native_loader.NativeImageLoader([str(work / "gray.jpg")]) as jl:
        if has_jpeg:
            jpeg_err = int(np.abs(jl[0].astype(int) - gray).max())
            if jpeg_err > 6:
                fail(f"the JPEG decodes {jpeg_err} away from the image written")
            jpeg = f"decoded, max abs err {jpeg_err} to the image written"
        else:
            try:
                jl[0]
            except IOError as e:
                if "jpeglib.h" not in str(e):
                    fail(f"a JPEG without jpeglib.h failed without naming it: {e}")
                jpeg = f"raised: {e}"
            else:
                fail("a JPEG decoded although the build found no jpeglib.h")

    cfg_path = loader_config_file(
        pkg_dir, work, "tum_odom.yaml", "planes_odom.yaml",
        {"type": "tum", "path": str(tum), "traj_file": traj, "intrinsics": K},
        work / "tum_out",
        kf={**yaml.safe_load((pkg_dir / "configs" / "planes_odom.yaml").read_text())["kf"],
            "translation_thresh": TUM_KF_TRANSLATION})
    cfg = load_config(str(cfg_path))
    runs, k2_inputs, k3_inputs = {}, {}, {}
    for name, native in (("native", True), ("image_io", False)):
        ds = TUMDataset(str(tum), traj_file=traj, intrinsics=K, native=native)
        fe = StructuredFakeFrontend(cfg, n_cells=64, device="cuda", device_sam=True)
        odom = Odometry(cfg, fe, ds, device="cuda")  # run_sfm --odom's loop
        reset_launch_counts()
        with read_waits(ds) as waits, first_inputs(torch, stencil, "bini_cg") as k2_in, \
                first_inputs(torch, k3, "phase_counts") as k3_in:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kf_traj = odom.run(max_frames=TUM_FRAMES)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = launch_counts()
        if launches["bini_cg"] == 0 or launches["phase_counts"] == 0:
            fail(f"the TUM odometry run ({name}) launched K2 {launches['bini_cg']} and K3 "
                 f"{launches['phase_counts']} times")
        poses = dict(odom.global_track_trajectory)
        if not all(np.isfinite(np.asarray(T)).all() for T in poses.values()):
            fail(f"the TUM odometry run ({name}) ended non-finite")
        gt = {ts: np.asarray(seq[int(ts)]["T"], np.float32) for ts in kf_traj}
        ate = ate_rmse(gt, kf_traj, align_scale=True)["rmse"] if len(gt) >= 3 else None
        runs[name] = {"wall_s": wall, "ms_per_tracked_frame": 1000 * wall / max(len(poses), 1),
                      "read_ms": waits, "read_ms_mean": float(np.mean(waits[1:])),
                      "keyframes": odom.num_kfs, "ate_sim3": ate, "launches": launches,
                      "poses": poses}
        if native:
            k2_inputs, k3_inputs = dict(k2_in), dict(k3_in)
    pose_diff = max(float(np.abs(np.asarray(runs["native"]["poses"][k])
                                 - np.asarray(runs["image_io"]["poses"][k])).max())
                    for k in runs["native"]["poses"] if k in runs["image_io"]["poses"])
    for run in runs.values():
        del run["poses"]
    k2_rows = [k2_row(torch, stencil, *args) for args in k2_inputs.values()]
    k3_rows = [k3_row(torch, k3, *args) for args in k3_inputs.values()]
    out = {"library": built.name, "build_s": build_s, "has_jpeg": has_jpeg, "jpeg": jpeg,
           "decode_threads": native_loader.default_threads(),
           "image_io_decode_ms": io_ms, "image_io_decode_ms_mean": float(np.mean(io_ms[1:])),
           "loader_wait_ms": wait_ms, "loader_wait_ms_mean": float(np.mean(wait_ms[1:])),
           "undistort_max_abs_diff": und_diff, "runs": runs,
           "native_vs_image_io_pose_max_abs_diff": pose_diff}
    print(f"native loader on {card}: built in {build_s:.2f} s ({built.name}), jpeglib.h "
          f"{'found' if has_jpeg else 'missing'} ({jpeg}); PNG decodes exact; undistort max "
          f"diff {und_diff}; per 480x640 frame image_io {out['image_io_decode_ms_mean']:.1f} ms, "
          f"loader wait once warm {out['loader_wait_ms_mean']:.2f} ms; TUM odometry ms per "
          f"tracked frame native {runs['native']['ms_per_tracked_frame']:.1f} (read "
          f"{runs['native']['read_ms_mean']:.2f} ms a frame), image_io "
          f"{runs['image_io']['ms_per_tracked_frame']:.1f} (read "
          f"{runs['image_io']['read_ms_mean']:.2f}); poses differ by {pose_diff:.2e}", flush=True)
    return runs["native"]["launches"], runs["image_io"]["launches"], k2_rows, k3_rows, out


def run_day0(torch, stencil, k3, work: Path, card: str) -> tuple[dict, dict]:
    """Phase 12b: the day-0 rehearsal on the card, ATE below 0.05."""
    from super_primitive_tpu_torch import day0_rehearsal

    reset_launch_counts()
    t0 = time.perf_counter()
    r = day0_rehearsal.rehearse(work / "day0", n_frames=8, device="cuda")
    wall = time.perf_counter() - t0
    launches = launch_counts()
    ate = r["ate"]["rmse"]
    if not ate < day0_rehearsal.ATE_LIMIT:
        fail(f"the day-0 rehearsal's ATE {ate} is not below {day0_rehearsal.ATE_LIMIT}")
    out = {"wall_s": wall, "ate": ate, "keyframes": r["ate"]["n"],
           "validation_tiers": {k: r["validation"][k]["tier"] for k in ("sam", "nnet")},
           "launches": launches}
    print(f"day-0 rehearsal on {card}: {wall:.1f} s, ATE {ate:.5f} over {r['ate']['n']} "
          f"keyframes, validation tiers {out['validation_tiers']}, launches {launches}",
          flush=True)
    return launches, out


def run_sam_fullres(torch, k3, decode: dict, f32_state_dict: dict, card: str):
    """Phase 12c: the SAM statistics and selection at out_size 512 on phase
    8's ViT-H features and bf16 decoder (K3 launched, exact), card against
    CPU on the same low-res logits; ``predict_batched_points`` with the
    float32 decoder, card against CPU."""
    import numpy as np

    from super_primitive_tpu_torch.image.resize import resize_bilinear
    from super_primitive_tpu_torch.nets.sam import predictor as pm
    from super_primitive_tpu_torch.nets.sam.image_encoder import VIT_H

    def decode_only(state_dict, dtype, device, orig_hw=None):
        p = pm.SamPredictor(state_dict, VIT_H, compute_dtype=dtype, device=device,
                            encoder=False)
        p.set_features(decode["features"], decode["input_hw"], orig_hw)
        return p

    t_phase = time.perf_counter()
    hw, T, out = tuple(decode["input_hw"]), 1024, FULLRES_OUT
    pred = decode_only(decode["state_dict"], decode["compute_dtype"], "cuda")
    pts = decode["pts"].numpy()
    reset_launch_counts()
    with first_inputs(torch, k3, "phase_counts") as k3_in:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks, iou, stab, area = pred.predict_points_with_stats(pts, out_size=out)
        stats_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sel = pred.predict_points_select(pts, iou_threshold=0.0, stability_threshold=0.0,
                                         out_size=out)
        select_s = time.perf_counter() - t0
    launches = launch_counts()
    if launches["phase_counts"] == 0:
        fail("the out_size != S statistics and selection did not launch K3")
    hs, ws = round(hw[0] * out / T), round(hw[1] * out / T)
    if masks.shape != (len(pts), 3, hs, ws) or not sel["keypoints_ids"].size:
        fail(f"the out_size {out} path gave masks {masks.shape} and "
             f"{sel['keypoints_ids'].size} selected keypoints")
    k3_rows = [k3_row(torch, k3, *args) for args in k3_in.values()]

    # card against CPU on the same low-res logits
    lowres, ious = pred._decode(torch.from_numpy(pts).cuda())
    lowres, ious = lowres[:, 1:].contiguous(), ious[:, 1:].contiguous()
    B, M, S = lowres.shape[0], lowres.shape[1], lowres.shape[-1]
    up = resize_bilinear(lowres.reshape(B * M, S, S), (out, out))
    up_cpu = resize_bilinear(lowres.cpu().reshape(B * M, S, S), (out, out))
    logit_err = float((up.cpu() - up_cpu).abs().max())
    tol = FULLRES_TOL * float(up_cpu.abs().max())
    if logit_err > tol:
        fail(f"the resized logits differ card against CPU by {logit_err:.3e} > {tol:.3e}")
    firm = (up_cpu.abs() >= tol).reshape(B, M, out, out).numpy()
    region = pm._region(out, hw, T, "cpu").numpy()
    card_stats = pm.stats_from_lowres(lowres, ious, hw, out, T)
    cpu_stats = pm.stats_from_lowres(lowres.cpu(), ious.cpu(), hw, out, T)
    bits = [pm._unpackbits_lastaxis(t[0]).cpu().numpy() for t in (card_stats, cpu_stats)]
    ties = int(((bits[0] != bits[1]) & ~firm & region).sum())
    if ((bits[0] != bits[1]) & firm).any():
        fail("the card's out_size != S masks differ from the CPU's away from ties")
    for name, g, w in zip(("stability", "area"), card_stats[2:], cpu_stats[2:]):
        if not torch.equal(g.cpu(), w):
            fail(f"the out_size != S {name} differs card against CPU")
    card_sel = pm.select_from_lowres(lowres, ious, hw, out, 0.0, 0.5, T)
    cpu_sel = pm.select_from_lowres(lowres.cpu(), ious.cpu(), hw, out, 0.0, 0.5, T)
    for name, g, w in zip(("iou", "valid", "pick"), (card_sel[1], card_sel[2], card_sel[4]),
                          (cpu_sel[1], cpu_sel[2], cpu_sel[4])):
        if not torch.equal(g.cpu(), w):
            fail(f"the out_size != S selection's {name} differs card against CPU")
    picked_firm = firm[np.arange(B), cpu_sel[4].numpy()]
    sel_bits = [pm._unpackbits_lastaxis(t[0]).cpu().numpy() for t in (card_sel, cpu_sel)]
    if ((sel_bits[0] != sel_bits[1]) & picked_firm).any():
        fail("the card's selected masks differ from the CPU's away from ties")
    box_rows = torch.from_numpy(~((sel_bits[0] != sel_bits[1]).any(axis=(1, 2))))
    if not torch.equal(card_sel[3].cpu()[box_rows], cpu_sel[3][box_rows]):
        fail("the card's selection boxes differ from the CPU's on rows without ties")

    # predict_batched_points, float32 decoder, card against CPU
    p_card = decode_only(f32_state_dict, None, "cuda", (480, 640))
    p_cpu = decode_only(f32_state_dict, None, "cpu", (480, 640))
    n = 64
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_card, i_card = p_card.predict_batched_points(pts[:n])
    batched_s = time.perf_counter() - t0
    m_cpu, i_cpu = p_cpu.predict_batched_points(pts[:n])
    errs = {"logits": rel_err(torch.from_numpy(m_card), torch.from_numpy(m_cpu)),
            "iou": rel_err(torch.from_numpy(i_card), torch.from_numpy(i_cpu))}
    if m_card.shape != (n, 3, 480, 640) or max(errs.values()) > NET_CARD_TOL["decoder"]:
        fail(f"predict_batched_points card against CPU: shape {m_card.shape}, errors {errs}")
    summary = {"out_size": out, "prompts": len(pts), "stats_s": stats_s, "select_s": select_s,
               "selected": int(sel["keypoints_ids"].size), "launches": launches,
               "resized_logit_max_abs_diff": logit_err, "tolerance": tol,
               "mask_ties": ties, "batched_points": n, "batched_s": batched_s,
               "batched_card_vs_cpu": errs, "phase_s": time.perf_counter() - t_phase}
    print(f"SAM at out_size {out} on {card}: stats {stats_s:.3f} s, selection {select_s:.3f} s "
          f"({summary['selected']} kept), K3 launched {launches['phase_counts']} times and "
          f"exact; resized logits card vs CPU {logit_err:.3e} (tolerance {tol:.3e}), "
          f"{ties} tied mask pixels; predict_batched_points on {n} prompts {batched_s:.3f} s, "
          f"card vs CPU {errs}", flush=True)
    return launches, k3_rows, summary


def check_normal_modes(torch, card: str) -> dict:
    """Phase 12d: ``photometric_cost`` in each normal mode, card against
    CPU, on a 240x320 scene of 12 segments with normal channels."""
    import numpy as np

    from super_primitive_tpu_torch.cost import normal_modes
    from super_primitive_tpu_torch.cost import photometric as ph
    from super_primitive_tpu_torch.keyframe import build_bundle_np
    from super_primitive_tpu_torch.lie import se3
    from super_primitive_tpu_torch.ops.sampling import pack_bilinear_taps

    r = np.random.default_rng(12)
    H, W = 240, 320
    K = np.asarray([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]], np.float32)
    regions = np.zeros((12, H, W), bool)
    for i in range(12):
        y, x = divmod(i, 4)
        regions[i, 20 + 70 * y:80 + 70 * y, 20 + 75 * x:85 + 75 * x] = True
    logdepth = (r.uniform(0.3, 0.8, (12, 1, 1)) * regions).astype(np.float32)
    kp_base = logdepth.max(axis=(1, 2))
    kp = (kp_base + r.normal(0, 0.02, 12)).astype(np.float32)
    xi = np.asarray([0.01, -0.02, 0.015, 0.02, -0.01, 0.005], np.float32)
    channels = {"colour": 3, "colour_norm": 6, "colour_norm_kappa": 7, "norm_kappa": 4}
    out = {}
    for mode in normal_modes.MODES:
        src, trg = (r.uniform(0, 1, (H, W, channels[mode])).astype(np.float32) for _ in range(2))
        costs = []
        for dev in ("cuda", "cpu"):
            b = build_bundle_np(regions, logdepth, device=dev)
            t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            s_ = ph.precompute_source(t(src), b, (H, W))
            costs.append(float(ph.photometric_cost(
                b, s_, pack_bilinear_taps(t(trg)), t(K), (H, W), t(kp), t(kp_base),
                se3.exp(t(xi)), mode=mode)))
        err = abs(costs[0] - costs[1]) / max(abs(costs[1]), 1e-30)
        if (mode == "norm_kappa" and costs != [0.0, 0.0]) or (mode != "norm_kappa"
                                                              and err > MODE_TOL):
            fail(f"photometric_cost({mode}) card {costs[0]} against CPU {costs[1]}")
        out[mode] = {"card": costs[0], "cpu": costs[1], "rel_err": err}
    print(f"normal modes on {card}: " + ", ".join(
        f"{m} {v['card']:.6f} (rel err {v['rel_err']:.1e})" for m, v in out.items()), flush=True)
    return out


def tree_mismatch(got, want, path: str = "") -> list[str]:
    """The leaves of two parameter trees that differ in their keys, dtype,
    shape or any bit."""
    import numpy as np

    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return [path or "/"]
        return [p for k in want for p in tree_mismatch(got[k], want[k], f"{path}/{k}")]
    got, want = np.asarray(got), np.asarray(want)

    def raw(x):  # the bytes, as a view where x is contiguous (no copy)
        return np.ascontiguousarray(x).reshape(-1).view(np.uint8)

    same = (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(raw(got), raw(want)))
    return [] if same else [path]


def day0_full_rank(mesh, work: str) -> dict:
    """Phase 12e's process (one rank of ``parallel/launch.run``: a fresh
    process, whose RSS holds only the leg): ``full_size_leg`` at ViT-H on the
    card with the launch counts reset just before and read just after, and
    K3's first inputs at each shape kept; then the converted tree against
    ``sam_to_flax`` of the same synthetic state dict, and the float32 ViT-H
    forward on it, warm."""
    import torch

    from super_primitive_tpu_torch import day0_rehearsal
    from super_primitive_tpu_torch.convert import (
        load_npz_tree,
        nnet_to_flax,
        sam_from_flax,
        sam_to_flax,
        save_npz_tree,
    )
    from super_primitive_tpu_torch.nets.sam.image_encoder import VIT_H
    from super_primitive_tpu_torch.nets.sam.predictor import SamPredictor
    from super_primitive_tpu_torch.nets.synth import synth_nnet_state_dict, synth_sam_state_dict
    from super_primitive_tpu_torch.nets.validate import sample_image
    from super_primitive_tpu_torch.ops import phase_counts as k3
    from super_primitive_tpu_torch.ops import stencil

    work = Path(work)
    nnet_npz = work / "nnet_scannet.npz"
    save_npz_tree(nnet_npz, nnet_to_flax(synth_nnet_state_dict()))
    with first_inputs(torch, k3, "phase_counts") as k3_inputs:
        reset_launch_counts()
        leg = day0_rehearsal.full_size_leg(work, nnet_npz, "cuda")
        launches = launch_counts()
    t0 = time.perf_counter()
    got = load_npz_tree(leg["npz"])
    mismatch = tree_mismatch(got, sam_to_flax(synth_sam_state_dict(VIT_H), depth=VIT_H.depth))
    compare_s = time.perf_counter() - t0
    predictor = SamPredictor(sam_from_flax(got), VIT_H, device="cuda")
    del got
    img_dev = predictor._upload(sample_image())
    forward_ms = time_ms(torch, lambda: predictor.encode(img_dev), reps=3)
    leg.update(pth=str(leg["pth"]), npz=str(leg["npz"]))
    return {"leg": leg, "launches": launches, "recorded": list(k3_inputs.values()),
            "mismatch": mismatch, "compare_s": compare_s, "f32_forward_ms": forward_ms}


def run_day0_full(torch, k3, work: Path, card: str) -> tuple[dict, list, dict]:
    """Phase 12e: the full-size day-0 leg in a process of its own
    (:func:`day0_full_rank`), its files under ``work``, deleted at the end;
    then K3 against its plain version, timed, on the inputs the leg gave
    it."""
    import shutil

    from super_primitive_tpu_torch.parallel import launch

    work.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        r = launch.run(day0_full_rank, 1, "gloo", "cuda", args=(str(work),), deadline=600)[0]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    leg, launches = r["leg"], r["launches"]
    if r["mismatch"]:
        fail(f"the full-size .npz differs from sam_to_flax's tree at {r['mismatch'][:8]}")
    if launches["phase_counts"] == 0:
        fail(f"the full-size leg did not launch K3: {launches}")
    k3_rows = [k3_row(torch, k3, *[a.cuda() if torch.is_tensor(a) else a for a in args])
               for args in r["recorded"]]
    out = {**{k: v for k, v in leg.items() if k not in ("pth", "npz", "sam_area")},
           "f32_forward_ms": r["f32_forward_ms"], "compare_s": r["compare_s"],
           "process_wall_s": wall, "launches": launches,
           "k3_device_ms": sum(row["device_ms"] for row in k3_rows)}
    print(f"full-size day-0 leg on {card}: .pth {leg['pth_bytes']:,} B, .npz "
          f"{leg['npz_bytes']:,} B (bit for bit sam_to_flax's); write {leg['write_s']:.1f} s, "
          f"convert {leg['convert_s']:.1f} s, validate {leg['validate_s']:.1f} s, step 2 "
          f"{leg['step2_s']:.1f} s; peak host RSS {leg['peak_rss_bytes'] / 2**30:.2f} GiB "
          f"({leg['rss_start_bytes'] / 2**30:.2f} at the leg's start), "
          f"peak device memory {leg['peak_device_bytes'] / 2**30:.2f} GiB; ViT-H float32 "
          f"forward {r['f32_forward_ms']:.1f} ms; K3 {launches['phase_counts']} launches, "
          f"device {out['k3_device_ms'] * 1e3:.2f} us; process {wall:.1f} s", flush=True)
    return launches, k3_rows, out


def run_slice10(torch, stencil, k3, pkg_dir: Path, decode: dict, f32_state_dict: dict,
                card: str):
    """Phase 12: the native loader (a), the day-0 rehearsal (b), the SAM
    predictor at out_size != S (c), the normal modes (d) and the full-size
    day-0 leg (e)."""
    import shutil

    t_phase = time.perf_counter()
    work = Path("build") / "chip_smoke" / "slice10"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    native_l, io_l, k2_loader, k3_loader, loader = run_native_loader(
        torch, stencil, k3, pkg_dir, work, card)
    day0_l, day0 = run_day0(torch, stencil, k3, work, card)
    fullres_l, k3_fullres, fullres = run_sam_fullres(torch, k3, decode, f32_state_dict, card)
    modes = check_normal_modes(torch, card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    full_l, k3_full, full = run_day0_full(torch, k3, work / "day0_full", card)
    full["phase_s"] = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    launches = {"loader_native": native_l, "loader_image_io": io_l, "day0": day0_l,
                "sam_fullres": fullres_l,
                "day0_full": full_l}
    summary = {"loader": loader, "day0": day0, "sam_fullres": fullres, "normal_modes": modes,
               "day0_full": full, "phase_s": time.perf_counter() - t_phase}
    print(f"phase 12 on {card}: {summary['phase_s']:.1f} s (12e {full['phase_s']:.1f} s)",
          flush=True)
    return launches, k2_loader, k3_loader, k3_fullres, k3_full, summary


def peak_alloc_bytes(torch, fn) -> int:
    """Device memory one call of ``fn`` allocates at its peak, over what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def sdpa_backends(torch, q, k, v) -> list[str]:
    """The backends of ``F.scaled_dot_product_attention`` that take these
    inputs (scale 1), each tried alone: the dispatcher takes one of them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    ok = []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                F.scaled_dot_product_attention(q, k, v, scale=1.0)
            ok.append(b.name)
        except RuntimeError:
            pass
    torch.cuda.synchronize()
    return ok


def k4_row(torch, k4, q, k, v, label: str) -> dict:
    """K4 on one input: in float32 against the float64 function within
    ``K4_F64_TOL`` of the plain version's distance from it, in bf16 against
    ext_attention_reference within ``K4_BF16_TOL`` of max|plain|; kernel
    (events and, at a path's widths, device) time, plain time, the library
    call's (``F.scaled_dot_product_attention`` with scale 1, timed here
    only) and the backends that take it, each one's peak device memory, and
    the bound at the inputs' type's peak."""
    import torch.nn.functional as F

    BH, L, d_qk = q.shape
    d_v = v.shape[2]
    dtype = str(q.dtype).removeprefix("torch.")
    got = k4.ext_attention(q, k, v)
    body = K4_BODIES[dtype]
    want = k4.ext_attention_reference(q, k, v).float()
    scale = float(want.abs().max())
    err = float((got.float() - want).abs().max()) / scale

    def library():
        return F.scaled_dot_product_attention(q, k, v, scale=1.0)

    lib_err = float((library().float() - want).abs().max()) / scale
    # both against the same function in float64 on the same inputs
    exact = (q.double() @ k.double().transpose(-2, -1)).softmax(dim=-1) @ v.double()
    exact_scale = float(exact.abs().max())
    f64_err = {"kernel": float((got.double() - exact).abs().max()) / exact_scale,
               "plain": float((want.double() - exact).abs().max()) / exact_scale}
    del exact
    ms = time_ms(torch, lambda: k4.ext_attention(q, k, v), reps=5)
    nbytes = (2 * d_qk + 2 * d_v) * BH * L * q.element_size()
    dev = {}
    if nbytes * 4 >= L2_BYTES:  # device_ms cycles 3x the L2 in copies: skip the tiny shape
        dev_ms, graph_ms, timer, attempts = device_ms(
            torch, k4.ext_attention, (q, k, v), K4_KERNEL_NAMES[dtype])
        dev = {"device_ms": dev_ms, "graph_ms": graph_ms, "device_timer": timer,
               "timing_attempts": attempts}
    plain_ms = time_ms(torch, lambda: k4.ext_attention_reference(q, k, v), reps=3)
    library_ms = time_ms(torch, library, reps=5)
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else TF32X3_FLOP_PER_S
    flops = 2 * BH * L * L * (d_qk + d_v)
    b_ms, b_by = bound_ms(nbytes, flops, peak)
    kernel_ms = dev.get("device_ms", ms)
    row = {"label": label, "shape": [BH, L, d_qk, d_v], "dtype": dtype, "body": body,
           "tflop_per_s": flops / kernel_ms / 1e9, "bound_share": b_ms / kernel_ms,
           "max_abs_err": err,
           "max_abs_err_of": "max|plain|", "library_err": lib_err, "err_vs_f64": f64_err,
           "ms": ms, **dev,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_backends": sdpa_backends(torch, q, k, v),
           "peak_bytes": peak_alloc_bytes(torch, lambda: k4.ext_attention(q, k, v)),
           "plain_peak_bytes": peak_alloc_bytes(
               torch, lambda: k4.ext_attention_reference(q, k, v)),
           "library_peak_bytes": peak_alloc_bytes(torch, library),
           "bound_ms": b_ms, "bound_by": b_by, "peak_flop_per_s": peak,
           "bytes": nbytes, "flops": flops}
    print(f"K4 {label} {BH}x{L}x{d_qk}/{d_v} {dtype} ({body} body): max err {err:.2e} of "
          f"max|plain| "
          f"(library {lib_err:.2e}; against float64 kernel {f64_err['kernel']:.2e}, plain "
          f"{f64_err['plain']:.2e}); kernel {ms:.3f} ms"
          + (f" (device {dev['device_ms']:.3f} ms, graph {dev['graph_ms']:.3f} ms)"
             if dev else "")
          + f", plain {plain_ms:.3f} ms, library {library_ms:.3f} ms "
          f"(backends that take it {row['library_backends']}); "
          f"bound {b_ms:.4f} ms ({b_by}, {peak / 1e12:.0f} TFLOP/s); "
          f"{row['tflop_per_s']:.1f} TFLOP/s, {100 * row['bound_share']:.1f}% of the bound; "
          f"peak memory kernel "
          f"{row['peak_bytes'] / 2**20:.1f} MiB, plain {row['plain_peak_bytes'] / 2**20:.1f} "
          f"MiB, library {row['library_peak_bytes'] / 2**20:.1f} MiB", flush=True)
    if dtype == "float32":
        factor, floor = K4_F64_TOL
        limit = factor * f64_err["plain"] + floor
        if not f64_err["kernel"] <= limit:
            fail(f"K4 departs from float64 at {label}: {f64_err['kernel']} > {limit}")
    elif not err <= K4_BF16_TOL:
        fail(f"K4 disagrees with its plain version at {label}: {err} > {K4_BF16_TOL}")
    if dev and dev["device_ms"] < b_ms:
        fail(f"K4's device time at {label} is below its bound")
    return row


def sass_counts(lib: Path) -> dict:
    """Tensor-core instructions in a built library's SASS (``cuobjdump
    -sass``): {"HGMMA": n, "HMMA": n, "by_function": {name: {...}}}, only
    functions that hold any."""
    from super_primitive_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts = {"HGMMA": 0, "HMMA": 0, "by_function": {}}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            continue
        for op in ("HGMMA", "HMMA"):
            if f" {op}." in line or f" {op} " in line:
                counts[op] += 1
                per = counts["by_function"].setdefault(fn, {"HGMMA": 0, "HMMA": 0})
                per[op] += 1
    return counts


def row_sass(sass: dict, row: dict) -> dict:
    """The tensor-core instruction counts of the function a K4 row ran: its
    dtype's body's instantiation for ceil(D_v / 16) value blocks."""
    name = K4_SASS_FUNCTIONS[row["body"]].format(-(-row["shape"][3] // 16))
    return next((c for fn, c in sass["by_function"].items() if name in fn),
                {"HGMMA": 0, "HMMA": 0})


def encoder_with(torch, cfg, weights: dict):
    """An ``ImageEncoderViT(cfg)`` on the card whose parameters are the
    tensors of ``weights`` (``image_encoder.*`` names without the prefix),
    shared, not copied."""
    from super_primitive_tpu_torch.nets.sam.image_encoder import ImageEncoderViT

    with torch.device("meta"):
        enc = ImageEncoderViT(cfg)
    enc.load_state_dict(weights, assign=True)
    return enc.eval().requires_grad_(False)


def run_attention(torch, k4, weights: dict, pkg_dir: Path, card: str):
    """Phase 13: the SAM encoder's attention lowerings and K4 at ViT-H.
    (b) the encoder on phase 8's weights at a trained net's scale, one
    1024² image: the two bf16 encoders the path runs, each with the config
    its predictor resolved (``bf16_ext``: the default predictor's, windowed
    and global "ext", persistent windows, tanh GELU; ``bf16_flash``: the
    predictor built with global "flash", which keeps the caller's config as
    the JAX package's does: windowed "xla" per block, exact GELU), and
    beside them
    bf16 under global "xla" and "flash" with the default's windows
    (``bf16_xla``, ``bf16_flash_persistent``) and "xla" with per-block
    partitions (``bf16_xla_per_block``), each within
    ``BF16_TOL["features"]`` of the float32 "xla" encoder, and the float32
    "flash" encoder within ``FLASH_F32_TOL`` of it; K4 launched 4 times a
    "flash" encode and never otherwise; each one's ms, busy ms, kernels and
    peak memory.  (c) the path, on phase 8's weights as they are (at a
    trained net's scale the random decoder gives no mask): one real-net
    keyframe through a FrontProcessor on the "flash" predictor (K4 and K3
    launched, finite), beside the default keyframe of
    ``frontend_from_state_dicts``.  (a) K4 against its plain version on the inputs the path's
    keyframe and the float32 flash encoder gave it, at a ragged and at the
    tiny config's shape."""
    import dataclasses

    import numpy as np

    from super_primitive_tpu_torch.data.synthetic import PlanesSequence
    from super_primitive_tpu_torch.frontend.process_frame import (
        FrontProcessor,
        frontend_from_state_dicts,
        wire_mask_predictor,
    )
    from super_primitive_tpu_torch.image.resize import linear_resize
    from super_primitive_tpu_torch.nets.sam.image_encoder import VIT_H
    from super_primitive_tpu_torch.nets.sam.predictor import PIXEL_MEAN, PIXEL_STD, SamPredictor
    from super_primitive_tpu_torch.nets.synth import scale_like_trained
    from super_primitive_tpu_torch.utils.numerics import float32_matmuls

    t_phase = time.perf_counter()
    float32_matmuls()
    cfg = real_nets_config(pkg_dir)
    ds = PlanesSequence(n_frames=1, H=480, W=640, path="linear")
    image_u8 = (np.clip(ds[0]["image"], 0, 1) * 255).astype(np.uint8)
    sam_img = linear_resize(image_u8, tuple(cfg.sam_params.infer_resolution))
    img = (torch.from_numpy(sam_img).cuda().float() - torch.tensor(PIXEL_MEAN).cuda()) \
        / torch.tensor(PIXEL_STD).cuda()
    T = VIT_H.img_size
    x32 = torch.nn.functional.pad(img, (0, 0, 0, T - img.shape[1], 0, T - img.shape[0]))[None]
    x16 = x32.to(torch.bfloat16)

    # the path's two frontends: the default one and one on a "flash" predictor
    fe = frontend_from_state_dicts(cfg, weights["sam"], weights["nnet"], "cuda")
    flash = SamPredictor(weights["sam"], dataclasses.replace(VIT_H, global_attn_impl="flash"),
                         compute_dtype=torch.bfloat16, device="cuda")
    fe_flash = FrontProcessor(cfg, fe.normals_fn, wire_mask_predictor(flash), device="cuda")

    # (b) the encoders, one set of device weights for each dtype, the
    # path's two under the configs their predictors resolved
    sd = scale_like_trained(weights["sam"])
    w32 = {k.removeprefix("image_encoder."): torch.from_numpy(np.asarray(v)).cuda()
           for k, v in sd.items() if k.startswith("image_encoder.")}
    del sd
    w16 = {k: v.to(torch.bfloat16) for k, v in w32.items()}
    default_cfg = fe.mask_predict_fn.predictor.cfg
    runs = {
        "bf16_xla": (encoder_with(torch, dataclasses.replace(default_cfg, global_attn_impl="xla"),
                                  w16), x16),
        "bf16_ext": (encoder_with(torch, default_cfg, w16), x16),
        "bf16_flash": (encoder_with(torch, flash.cfg, w16), x16),
        "bf16_flash_persistent": (encoder_with(
            torch, dataclasses.replace(default_cfg, global_attn_impl="flash"), w16), x16),
        # the bf16 lowering before the predictor's switch: materialised bias
        # in every block, one partition a block
        "bf16_xla_per_block": (encoder_with(torch, dataclasses.replace(VIT_H, gelu_approx=True),
                                            w16), x16),
        "f32_xla": (encoder_with(torch, VIT_H, w32), x32),
        "f32_flash": (encoder_with(torch, dataclasses.replace(VIT_H, global_attn_impl="flash"),
                                   w32), x32),
    }
    feats, k4_inputs = {}, {}
    for name, (enc, x) in runs.items():
        with first_inputs(torch, k4, "ext_attention") as seen:
            reset_launch_counts()
            feats[name] = enc(x).float()
            torch.cuda.synchronize()
            n = launch_counts()["ext_attention"]
        if name == "f32_flash":
            k4_inputs.update({(name, shape): args for shape, args in seen.items()})
        want = len(VIT_H.global_attn_indexes) if enc.cfg.global_attn_impl == "flash" else 0
        if n != want:
            fail(f"the {name} encoder launched K4 {n} times, not {want}")
    ref = feats["f32_xla"]
    enc_rows = {}
    for name, (enc, x) in runs.items():
        ecfg = enc.cfg
        ms = time_ms(torch, lambda: enc(x), reps=2 if name.startswith("f32") else 5)
        busy, kernels = busy_ms(torch, lambda: enc(x))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc(x)  # the host's time to enqueue one encode: the wall's floor
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(feats[name]).all())
        enc_rows[name] = {"config": {f: getattr(ecfg, f) for f in (
                              "global_attn_impl", "windowed_attn_impl", "persistent_windows",
                              "gelu_approx")},
                          "err_vs_f32_xla": rel_err(feats[name], ref), "ms": ms,
                          "busy_ms": busy,
                          "kernels": kernels, "idle_share": 1.0 - busy / ms,
                          "host_enqueue_ms": host,
                          "peak_bytes": peak_alloc_bytes(torch, lambda: enc(x)),
                          "k4_launches": len(VIT_H.global_attn_indexes)
                          if ecfg.global_attn_impl == "flash" else 0, "finite": finite}
        print(f"ViT-H encoder {name} on {card}: {ms:.2f} ms, busy {busy:.2f} ms in {kernels} "
              f"kernels, host enqueue {host:.2f} ms, peak "
              f"{enc_rows[name]['peak_bytes'] / 2**30:.3f} GiB, features against float32 xla "
              f"{enc_rows[name]['err_vs_f32_xla']:.3e}; {enc_rows[name]['config']}", flush=True)
        if not finite:
            fail(f"the {name} encoder's features are not finite")
    bad = [n for n in runs if n.startswith("bf16")
           if not enc_rows[n]["err_vs_f32_xla"] <= BF16_TOL["features"]]
    if bad:
        fail(f"bf16 encoders {bad} depart from float32 beyond {BF16_TOL['features']}")
    if not enc_rows["f32_flash"]["err_vs_f32_xla"] <= FLASH_F32_TOL:
        fail(f"the float32 flash encoder departs from float32 xla beyond {FLASH_F32_TOL}")
    del runs, feats, ref, w32, w16
    torch.cuda.empty_cache()

    # (c) the path: a real-net keyframe on the bf16 "flash" SAM predictor;
    # K4's path inputs are those of its warm-up keyframe
    kf = {}
    for name, front in (("ext", fe), ("flash", fe_flash)):
        with first_inputs(torch, k4, "ext_attention") as seen:
            front.process_to_kf(ds[0]["image"], ds[0]["intrinsics"])  # warm
        k4_inputs.update({("bf16_flash", shape): args for shape, args in seen.items()})
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = front.process_to_kf(ds[0]["image"], ds[0]["intrinsics"])
        torch.cuda.synchronize()
        kf[name] = {"s": time.perf_counter() - t0, "segments": int(out["regions"].shape[0]),
                    "launches": launch_counts(),
                    "finite": bool(np.isfinite(out["logdepth_perseg"]).all()
                                   and np.isfinite(out["normals"]).all())}
    path_launches = kf["flash"]["launches"]
    print(f"real-net keyframe on {card}, bf16 SAM global flash: {kf['flash']['s']:.3f} s, "
          f"{kf['flash']['segments']} segments, launches {path_launches}; default (ext): "
          f"{kf['ext']['s']:.3f} s, {kf['ext']['segments']} segments", flush=True)
    if path_launches["ext_attention"] != len(VIT_H.global_attn_indexes) \
            or path_launches["phase_counts"] == 0 or not kf["flash"]["finite"]:
        fail(f"the flash keyframe: launches {path_launches}, finite {kf['flash']['finite']}")
    if kf["ext"]["launches"]["ext_attention"] != 0:
        fail("the default keyframe launched K4")
    del fe, fe_flash, flash
    torch.cuda.empty_cache()

    # (a) K4 against its plain version
    path_rows = [k4_row(torch, k4, *k4_inputs[key], label=key[0])
                 for key in sorted(k4_inputs) if key[0] == "bf16_flash"]
    check_rows = [k4_row(torch, k4, *k4_inputs[key], label=key[0])
                  for key in sorted(k4_inputs) if key[0] == "f32_flash"]
    r = np.random.default_rng(13)
    for label, (BH, L, d_qk, d_v) in (("ragged", K4_RAGGED), ("tiny", K4_TINY)):
        q, k = (torch.from_numpy(0.3 * r.normal(size=(BH, L, d_qk)).astype(np.float32)).cuda()
                for _ in range(2))
        v = torch.from_numpy(r.normal(size=(BH, L, d_v)).astype(np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            check_rows.append(k4_row(torch, k4, q.to(dtype), k.to(dtype), v.to(dtype),
                                     label=label))
    del k4_inputs
    torch.cuda.empty_cache()
    from super_primitive_tpu_torch.ops import _build

    sass = sass_counts(_build._library_path("ext_attention.cu"))
    print(f"K4 SASS: {sass['HGMMA']} HGMMA, {sass['HMMA']} HMMA in "
          f"{len(sass['by_function'])} functions", flush=True)
    if sass["HGMMA"] + sass["HMMA"] == 0:
        fail("K4's library holds no tensor-core instruction")
    for row in path_rows + check_rows:
        row["sass"] = row_sass(sass, row)
        if row["sass"]["HGMMA"] == 0:
            fail(f"K4's {row['body']} body for {row['shape']} holds no HGMMA")
    summary = {"encoders": enc_rows, "keyframes": kf, "k4_sass": sass,
               "phase_s": time.perf_counter() - t_phase}
    print(f"phase 13 on {card}: {summary['phase_s']:.1f} s", flush=True)
    return path_launches, path_rows, check_rows, summary


def main() -> int:
    # torch.profiler tears CUPTI down after each session and sets it up again
    # at the next; once CUDA graphs have run (device_ms replays them) a later
    # session can then report no kernels.  torch's own workaround, which it
    # applies only to inductor's graphs: keep CUPTI up.
    os.environ["TEARDOWN_CUPTI"] = "0"
    os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
    import torch

    import super_primitive_tpu_torch as pkg

    here = Path(__file__).resolve().parent
    if Path(pkg.__file__).resolve().parent.parent != here:
        print("chip_smoke: super_primitive_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from super_primitive_tpu_torch.integrate import bini
    from super_primitive_tpu_torch.ops import _build, stencil
    from super_primitive_tpu_torch.ops import attention as k4
    from super_primitive_tpu_torch.ops import phase_counts as k3
    from super_primitive_tpu_torch.ops import sam_frame as sf
    from super_primitive_tpu_torch.run_sfm import require_device

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    require_device("cuda")
    t_start = time.perf_counter()
    built = _build.build_all()
    phase_s = {"build": built["seconds"]}

    def phase(name, fn, *args):
        """fn(*args), its wall seconds kept under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    print(f"kernels built in {built['seconds']:.1f} s", flush=True)
    for src, log in built["log"].items():
        for line in log.splitlines():
            # not ptxas's C7519 notes (one a wgmma of K4's bf16 body)
            if ("registers" in line or "spill" in line) and "C7519" not in line:
                print(f"  {src}: {line.strip()}")

    pkg_dir = Path(pkg.__file__).resolve().parent
    k1 = phase("2_k1", check_k1, torch, bini, stencil)
    k2 = phase("3_k2", check_k2, torch, bini, stencil)
    k3_checks = phase("3b_k3", check_k3, torch, k3)
    sf_checks = phase("3c_sam_frame", check_sam_frame, torch, sf)
    k1_launches, k1_path = phase("4_bini_480", check_bini_480, torch, bini, stencil)
    k2_launches, k2_path, adam_slice = phase("5_two_frame", run_slice, torch, stencil)
    tf_gn_launches, tf_gn = phase("5b_two_frame_gn", run_slice_gn, torch, stencil, k3,
                                  adam_slice)
    phase("6_small_inputs", small_input_agreement, torch)
    gn_small = phase("6_gn_card_vs_cpu", gn_card_vs_cpu, torch)
    vo_launches, k2_vo, k3_vo, vo, vo_inputs = phase("7_vo", run_vo, torch, stencil, k3)
    vo_gn_launches, vo_gn, sharded_inputs = phase("7b_vo_gn", run_vo_gn, torch, stencil, k3,
                                                  vo, vo_inputs)
    rn_launches, k2_rn, k3_rn, sf_rn, rn, decode_inputs, net_weights = phase(
        "8_real_nets", run_real_nets, torch, stencil, k3, pkg_dir, smi)
    void_launches, k2_void, k3_void, sf_void, void = phase("9_void", run_void, torch, stencil, k3,
                                                  pkg_dir, net_weights, smi)
    torch.cuda.empty_cache()
    resume_launches, resume = phase("10_resume", run_resume, torch, stencil, k3, smi)
    torch.cuda.empty_cache()
    f32_decoder = decode_inputs.pop("state_dict_f32")
    sharded_launches, k2_sh, k3_sh, sharded = phase(
        "11_sharded", run_sharded, torch, stencil, k3, sharded_inputs["gn"],
        sharded_inputs["bini"], decode_inputs, smi)
    torch.cuda.empty_cache()
    s10_launches, k2_loader, k3_loader, k3_fullres, k3_day0_full, slice10 = phase(
        "12_slice10", run_slice10, torch, stencil, k3, pkg_dir, decode_inputs, f32_decoder, smi)
    torch.cuda.empty_cache()
    attn_launches, k4_path, k4_checks, attention = phase(
        "13_attention", run_attention, torch, k4, net_weights, pkg_dir, smi)
    del net_weights
    phase_s["total"] = time.perf_counter() - t_start
    print(f"phase seconds on {smi}: " + json.dumps({k: round(v, 1) for k, v in phase_s.items()}),
          flush=True)

    def path_sums(rows):
        """A path's kernel numbers summed over its recorded inputs."""
        b_ms, b_by = bound_ms(sum(r["bytes"] for r in rows), sum(r["flops"] for r in rows))
        dev = [r.get("device_ms") for r in rows]
        lib = [r.get("library_ms") for r in rows]
        return {"ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
                **({} if None in dev else {"device_ms": sum(dev)}),
                "library_ms": None if None in lib else sum(lib), "bound_ms": b_ms,
                "bound_by": b_by, "max_abs_err": max(r["max_abs_err"] for r in rows)}

    def entry(name, replaces, launches, path_rows, other_rows, flop_per_s=F32_FLOP_PER_S,
              **extra):
        """One kernel's line: its numbers summed over the path's recorded
        inputs (one call at each shape the path gave it)."""
        nbytes = sum(r["bytes"] for r in path_rows)
        flops = sum(r["flops"] for r in path_rows)
        b_ms, b_by = bound_ms(nbytes, flops, flop_per_s)
        lib = [r.get("library_ms") for r in path_rows]
        dev = [r.get("device_ms") for r in path_rows]
        graph = [r.get("graph_ms") for r in path_rows]
        return {"name": name, "route": "cuda",
                "source": f"super_primitive_tpu_torch/ops/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in path_rows),
                "ms": sum(r["ms"] for r in path_rows),
                **({} if None in dev else {"device_ms": sum(dev), "graph_ms": sum(graph)}),
                "plain_ms": sum(r["plain_ms"] for r in path_rows),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None if None in lib else sum(lib),
                **extra, "path_shapes": path_rows, "check_shapes": other_rows}

    # K4 runs only where a caller asks for global "flash": no earlier path
    earlier_k4 = {"bini_480": k1_launches["ext_attention"],
                  "two_frame": k2_launches["ext_attention"],
                  "two_frame_gn": tf_gn_launches["ext_attention"],
                  "vo": vo_launches["ext_attention"], "vo_gn": vo_gn_launches["ext_attention"],
                  "real_nets": rn_launches["ext_attention"],
                  "void": void_launches["ext_attention"],
                  "resume": resume_launches["ext_attention"],
                  "sharded": sharded_launches["ext_attention"],
                  **{p: n["ext_attention"] for p, n in s10_launches.items()}}
    if any(earlier_k4.values()):
        fail(f"K4 launched on a path that does not ask for it: {earlier_k4}")
    path_launches = {"bini_480": k1_launches, "two_frame": k2_launches,
                     "two_frame_gn": tf_gn_launches, "vo": vo_launches, "vo_gn": vo_gn_launches,
                     "real_nets": rn_launches, "void": void_launches,
                     "resume": resume_launches, "sharded": sharded_launches, **s10_launches,
                     "real_net_flash_keyframe": attn_launches}
    sf_launches = {p: n["sam_frame"] for p, n in path_launches.items()}
    kernels = [
        entry("bini_apply", "super_primitive_tpu/ops/pallas_stencil.py:71",
              k1_launches["bini_apply"], k1_path, k1,
              launches_by_path={"bini_480": k1_launches["bini_apply"],
                                "two_frame": k2_launches["bini_apply"],
                                "two_frame_gn": tf_gn_launches["bini_apply"],
                                "vo": vo_launches["bini_apply"],
                                "vo_gn": vo_gn_launches["bini_apply"],
                                "real_nets": rn_launches["bini_apply"],
                                "void": void_launches["bini_apply"],
                                "resume": resume_launches["bini_apply"],
                                "sharded": sharded_launches["bini_apply"],
                                **{p: n["bini_apply"] for p, n in s10_launches.items()}}),
        entry("bini_cg", "super_primitive_tpu/ops/pallas_stencil.py:175",
              vo_launches["bini_cg"], k2_vo, k2,
              launches_by_path={"two_frame": k2_launches["bini_cg"],
                                "two_frame_gn": tf_gn_launches["bini_cg"],
                                "vo": vo_launches["bini_cg"],
                                "vo_gn": vo_gn_launches["bini_cg"],
                                "real_nets": rn_launches["bini_cg"],
                                "void": void_launches["bini_cg"],
                                "resume": resume_launches["bini_cg"],
                                "sharded": sharded_launches["bini_cg"],
                                **{p: n["bini_cg"] for p, n in s10_launches.items()}},
              two_frame_path_shapes=k2_path, real_nets_path_shapes=k2_rn,
              void_path_shapes=k2_void, void_path=path_sums(k2_void),
              sharded_path_shapes=k2_sh, sharded_path=path_sums(k2_sh),
              loader_path_shapes=k2_loader, loader_path=path_sums(k2_loader)),
        entry("phase_counts", "super_primitive_tpu/ops/pallas_phase_counts.py:77",
              vo_launches["phase_counts"], k3_vo, k3_checks,
              launches_by_path={"two_frame_gn": tf_gn_launches["phase_counts"],
                                "vo": vo_launches["phase_counts"],
                                "vo_gn": vo_gn_launches["phase_counts"],
                                "real_nets": rn_launches["phase_counts"],
                                "void": void_launches["phase_counts"],
                                "resume": resume_launches["phase_counts"],
                                "sharded": sharded_launches["phase_counts"],
                                **{p: n["phase_counts"] for p, n in s10_launches.items()}},
              real_nets_path_shapes=k3_rn, void_path_shapes=k3_void,
              void_path=path_sums(k3_void), sharded_path_shapes=k3_sh,
              sharded_path=path_sums(k3_sh), loader_path_shapes=k3_loader,
              loader_path=path_sums(k3_loader), sam_fullres_path_shapes=k3_fullres,
              sam_fullres_path=path_sums(k3_fullres), day0_full_path_shapes=k3_day0_full,
              day0_full_path=path_sums(k3_day0_full)),
        entry("ext_attention", "super_primitive_tpu/nets/sam/image_encoder.py:249",
              attn_launches["ext_attention"], k4_path, k4_checks, flop_per_s=BF16_FLOP_PER_S,
              launches_by_path=earlier_k4 | {"real_net_flash_keyframe":
                                             attn_launches["ext_attention"]},
              body=sorted({r["body"] for r in k4_path}),
              tflop_per_s=sum(r["flops"] for r in k4_path) / 1e9
              / sum(r.get("device_ms", r["ms"]) for r in k4_path),
              sass={op: attention["k4_sass"][op] for op in ("HGMMA", "HMMA")}),
        entry("sam_frame", "super_primitive_tpu/frontend/process_frame.py:204 and "
              "nets/sam/predictor.py:634 (cv2.resize on the host; no Pallas kernel)",
              void_launches["sam_frame"], sf_void, sf_checks, launches_by_path=sf_launches,
              real_nets_path_shapes=sf_rn,
              prepare_frame_ms=statistics.median(r["prepare_frame_ms"] for r in sf_void)),
    ]
    print(json.dumps({"vo_slice": vo}))
    print(json.dumps({"two_frame_gn": tf_gn, "gn_card_vs_cpu": gn_small, "vo_slice_gn": vo_gn}))
    print(json.dumps({"real_nets": rn}))
    print(json.dumps({"void": void}))
    print(json.dumps({"resume": resume}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"slice10": slice10}))
    print(json.dumps({"attention": attention}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
