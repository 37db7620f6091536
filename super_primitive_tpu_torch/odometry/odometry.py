"""Monocular visual odometry loop, with the Adam and the GN/LM solvers.

Port of ``super_primitive_tpu/odometry/odometry.py`` (``Odometry``): per
frame, track -> per-frame 'supp' mapping -> scheduled 'map' mapping ->
keyframe gating -> keyframe init (with depth re-initialisation from the
rendered depth) -> window roll.  Tracking, mapping and the depth render run
as PyTorch on the loop's device (``tracker.py``, ``mapper.py``,
``solve/gauss_newton.py``, ``solve/gn_mapping.py``, ``ops/scatter.py``);
this file shuffles slots and timestamps on the host.

``alignment.track.solver`` and ``alignment.mapping.solver`` pick ``adam``
(the reference's solver) or ``gn`` (LM).  With both on ``gn`` and the
system initialised, a tracked frame is one ``fused_step.fused_frame_step``
(track, supporting-slot refresh, supp refinement, gating) under the timer
stage ``fused_frame``, and its gating feeds the next keyframe decision;
the keyframe-cadence work (window mapping, keyframe init) stays separate.
The fused step updates the device log-depths without a host copy; the host
keyframes' copies follow at the next window mapping, or lazily
(``_sync_host_logdepth``) at the end of a run.

The frontend is injected (``process_to_kf(image, K)`` -> host geometry,
``process_to_supp_kf`` -> image only), so the fake SAM/normals frontend and
the GT-depth stub are interchangeable.

Checkpoints (``io.py``'s layout, which the JAX package shares):
``save_state`` writes the window's host keyframes and the trajectories,
every ``save_every`` frames and at the end of a run when that is set;
``config.restore`` makes ``run`` reload a checkpoint (``load_state``) and
continue after its frame; ``dump_kfs`` writes each keyframe that leaves the
window.  ``live_cb(odom, frame_id)``, when set, runs after every frame (the
live viewer of ``run_sfm --live-viz``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Protocol

import numpy as np
import torch

from ..config.schema import Config
from ..image import pyramid as pyr
from ..keyframe import build_bundle_np
from ..solve.gauss_newton import gn_track_frame
from ..solve.gn_mapping import gn_mapping
from ..utils.numerics import float32_matmuls
from ..utils.timing import StageTimer, to_host
from . import depth_init, io, kf_criteria, mapper, tracker, window
from .fused_step import fused_frame_step



class Frontend(Protocol):
    def process_to_kf(self, image: np.ndarray, K: np.ndarray) -> dict: ...
    def process_to_supp_kf(self, image: np.ndarray, K: np.ndarray) -> dict: ...


@dataclasses.dataclass
class TrackedFrame:
    timestamp: str
    image: torch.Tensor        # device image (H, W, C)
    pose: np.ndarray           # (4, 4) world
    affine: np.ndarray         # (2,)


class Odometry:
    """The odometry loop on ``device`` (default the card)."""

    def __init__(self, config: Config, frontend: Frontend, dataset,
                 device: str | torch.device = "cuda"):
        a = config.alignment
        for part in (a.track, a.mapping):
            if part.solver not in ("adam", "gn"):
                raise ValueError(f"unknown solver {part.solver!r}; use adam or gn")
        float32_matmuls()
        self.config = config
        self.frontend = frontend
        self.dataset = dataset
        self.device = torch.device(device)

        self.window_size = config.window_size
        self.supp_cap = max(2, a.mapping.supp_every_n - 1)
        self.affine_compensation = a.affine_compensation
        self.opt_supporting = a.opt_supporting
        self.mono_init = a.mono_init

        self.buffers: Optional[window.WindowBuffers] = None
        self.host_kfs: list[window.HostKeyFrame] = []
        self.num_kfs = 0
        self.seg_cap = None
        self.point_cap = None
        # host mirror of buffers.supp_valid: every supp change is host driven
        self.supp_valid_host: Optional[np.ndarray] = None
        self._last_gate: Optional[tuple] = None  # the fused step's gating
        self._host_ld_dirty = False
        # LM iterations of each GN call: track (a level), supp, init, map
        self.gn_iters: dict[str, list[int]] = {"track": [], "supp": [], "init": [], "map": []}

        self.tracked: list[TrackedFrame] = []
        self.current_track: Optional[np.ndarray] = None
        self.current_aff = np.zeros(2, np.float32)
        self.current_ts: Optional[str] = None
        self.initialised = False
        self.mapping_scheduled = False
        self.global_kf_trajectory: dict[str, np.ndarray] = {}
        self.global_track_trajectory: dict[str, np.ndarray] = {}
        self.frame_timestamps: dict[str, float] = {}
        # (timestamp, wall s, segments) per init_keyframe
        self.kf_add_log: list[tuple[str, float, int]] = []
        self._kf_pyramid_cache = None  # (kf timestamp, level images)

        self.timer = StageTimer(self.device)
        # the frontend's stages (sam rounds, bini, split) land in this timer
        if getattr(frontend, "timer", "absent") is None:
            frontend.timer = self.timer
        # callable(odom, frame_id) after every frame, set by callers
        # (run_sfm --live-viz, viz/live.py)
        self.live_cb = None

    # ------------------------------------------------------------- helpers
    @staticmethod
    def id_to_timestamp(frame_id: int) -> str:
        return str(frame_id).zfill(6)

    def _geo_dims(self) -> tuple[int, int]:
        return tuple(self.host_kfs[-1].logdepth_perseg.shape[1:])

    def _tensor(self, x) -> torch.Tensor:
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    def estimate_depth_latest_kf(self, pose: np.ndarray) -> np.ndarray:
        """Render the last keyframe's points into the camera at ``pose``."""
        return to_host(kf_criteria.render_kf_depth(self.buffers, self.num_kfs - 1,
                                                   self._tensor(pose), self._geo_dims()))

    # -------------------------------------------------------- keyframe init
    def init_keyframe(self, frame: dict, pose: np.ndarray, timestamp: str):
        t0 = time.perf_counter()
        counts0 = dict(self.timer.counts)
        observe = getattr(self.frontend, "observe", None)
        if observe is not None:
            observe(frame)
        with self.timer.stage("kf_frontend"):
            kf_data = self.frontend.process_to_kf(frame["image"], frame["intrinsics"])
        regions = kf_data["regions"]
        logdepth = kf_data["logdepth_perseg"]
        keypoints_rc = kf_data["keypoints_rc"]
        image = kf_data["image"]
        K = kf_data["K"]
        N_i, Hg, Wg = regions.shape

        self._ensure_window(regions, image)

        if self.num_kfs < 2:
            if self.mono_init:
                kp_logdepth = np.zeros(N_i, np.float32)  # log(1.0)
            else:
                # ground-truth init: lookup at the keypoints, per-segment
                # median where a lookup is invalid; initialised at once
                gt = np.asarray(frame["depth"], np.float32)
                if gt.shape != (Hg, Wg):
                    sy, sx = gt.shape[0] // Hg, gt.shape[1] // Wg
                    gt = gt[::sy, ::sx][:Hg, :Wg]
                direct = gt[keypoints_rc[:, 0], keypoints_rc[:, 1]]
                if np.any(direct < 1e-6):
                    kp_logdepth = depth_init.segment_based_depth_reinit(
                        gt, regions, logdepth, keypoints_rc)
                else:
                    kp_logdepth = np.log(direct).astype(np.float32)
                self.initialised = True
        else:
            with self.timer.stage("kf_depth_reinit"):
                est = self.estimate_depth_latest_kf(pose)
                kp_logdepth = depth_init.segment_based_depth_reinit(
                    est, regions, logdepth, keypoints_rc)
        if not np.all(np.isfinite(kp_logdepth)):
            raise FloatingPointError(f"keyframe {timestamp}: non-finite depth init")

        host_kf = window.HostKeyFrame(
            timestamp=timestamp, image=image, K=K, regions=regions,
            logdepth_perseg=logdepth, keypoints_rc=keypoints_rc,
            pose=np.asarray(pose, np.float32), kp_logdepth=kp_logdepth,
            affine=self.current_aff.copy(),
        )
        if self.num_kfs == self.window_size:
            with self.timer.stage("kf_roll"):
                if self.config.dump_kfs:
                    self._sync_host_logdepth()
                    io.dump_kf(self.config.save_path + "/curr_kfs", self.host_kfs[0])
                self.host_kfs.pop(0)
                window.roll_window(self.buffers)
                self.supp_valid_host = np.concatenate(
                    [self.supp_valid_host[1:], np.zeros_like(self.supp_valid_host[:1])])
                self.num_kfs -= 1

        with self.timer.stage("kf_slot_put"):
            self._put_keyframe(host_kf)
        self.global_kf_trajectory[timestamp] = np.asarray(pose)
        self._kf_pyramid_cache = None
        wall = time.perf_counter() - t0
        self.kf_add_log.append((timestamp, wall, N_i))
        stages = {
            (k[3:] if k.startswith("kf_") else k): round(1000 * v)
            for k, v in self.timer.last.items()
            if self.timer.counts[k] > counts0.get(k, 0)
        }
        print(f"[kf] added {timestamp} (N={N_i}, {wall:.2f}s; stages_ms={stages})", flush=True)

    def _ensure_window(self, regions: np.ndarray, image: np.ndarray):
        """Allocate the window at the first keyframe: capacities fixed by
        its segment count and region pixels."""
        if self.seg_cap is not None:
            return
        N_i, Hg, Wg = regions.shape
        self.seg_cap = max(64, int(np.ceil(N_i * 1.5 / 32) * 32))
        self.point_cap = int(np.ceil(max(int(regions.sum()) * 2, Hg * Wg) / 1024) * 1024)
        self.buffers = window.empty_window(
            self.window_size, self.supp_cap, image.shape[:2], image.shape[2],
            self.seg_cap, self.point_cap, device=self.device)
        self.supp_valid_host = np.zeros((self.window_size, self.supp_cap), bool)

    def _put_keyframe(self, kf: window.HostKeyFrame):
        """Write host keyframe ``kf`` into the next free window slot."""
        slot = self.num_kfs
        n = kf.regions.shape[0]
        bundle = build_bundle_np(kf.regions, kf.logdepth_perseg, capacity=self.point_cap,
                                 device=self.device)
        kp_base = kf.logdepth_perseg[np.arange(n), kf.keypoints_rc[:, 0], kf.keypoints_rc[:, 1]]
        window.set_keyframe_slot(self.buffers, slot, kf.image, kf.K, kf.pose, kf.kp_logdepth,
                                 kf.affine, bundle, kp_base)
        self.supp_valid_host[slot] = False
        self.host_kfs.append(kf)
        self.num_kfs += 1

    # ------------------------------------------------------------ tracking
    def _kf_track_pyramid(self):
        ts = self.host_kfs[-1].timestamp
        if self._kf_pyramid_cache is None or self._kf_pyramid_cache[0] != ts:
            t = self.config.alignment.track
            levels = pyr.image_pyramid(self.buffers.images[self.num_kfs - 1],
                                       t.pyramid_min, t.pyramid_max)
            self._kf_pyramid_cache = (ts, levels)
        return self._kf_pyramid_cache[1]

    def track_frame(self, frame: dict, timestamp: str) -> dict:
        t0 = time.perf_counter()
        with self.timer.stage("track"):
            with self.timer.stage("track_prep"):
                supp = self.frontend.process_to_supp_kf(frame["image"], frame["intrinsics"])
                trg_image = self._tensor(supp["image"])
            i = self.num_kfs - 1
            b = self.buffers
            t = self.config.alignment.track
            args = (b.bundle_at(i), self._kf_track_pyramid())
            kf_args = (b.K[i], b.kp_logdepth[i], b.kp_base[i],
                       self._tensor(self.host_kfs[-1].pose), self._tensor(self.current_track),
                       b.affine[i], self._tensor(self.current_aff), self._geo_dims())
            if t.solver == "gn":
                trg_pyr = pyr.image_pyramid(trg_image, t.pyramid_min, t.pyramid_max)
                T_frame, affine, infos = gn_track_frame(
                    *args, trg_pyr, *kf_args, levels=self._track_levels(),
                    max_iters=t.gn_max_iters, use_affine=bool(self.affine_compensation))
                self.gn_iters["track"] += [r.num_iters for r in infos]
                # the finest level's final cost, as the Adam path reports
                final = (infos[-1].final_cost[None] if infos
                         else torch.full((1,), float("nan"), device=self.device))
            else:
                T_frame, affine, losses = tracker.track_frame(
                    *args, trg_image, *kf_args, tuple(t.steps), t.lr, t.pyramid_min,
                    t.pyramid_max, use_affine=bool(self.affine_compensation),
                )
                final = losses[-1][-1:] if losses else torch.full((1,), float("nan"),
                                                                 device=self.device)
            out = to_host(torch.cat([T_frame.reshape(16), affine, final]))
        T_frame_np = out[:16].reshape(4, 4)
        self.current_track = T_frame_np
        self.current_aff = out[16:18].copy()
        self.current_ts = timestamp
        self.tracked.append(TrackedFrame(timestamp, trg_image, T_frame_np, self.current_aff.copy()))
        self.global_track_trajectory[timestamp] = T_frame_np
        print(f"tracking time {time.perf_counter() - t0:.3f} sec, tracking loss = "
              f"{float(out[18]):.4f}", flush=True)
        return {"pose": T_frame_np, "affine": self.current_aff, "ts": timestamp}

    def _track_levels(self) -> list[int]:
        """The pyramid levels GN tracks: those the step schedule marks
        active."""
        return [lv for lv, n in enumerate(self.config.alignment.track.steps) if n > 0]

    # ------------------------------------------------ fused per-frame step
    def _fused_enabled(self) -> bool:
        """Steady-state frames of the GN path take the fused step; other
        solver configurations track and refine separately."""
        a = self.config.alignment
        return (self.initialised and a.track.solver == "gn" and a.mapping.solver == "gn"
                and self.num_kfs >= 1)

    def fused_frame(self, frame: dict, timestamp: str) -> dict:
        """Track, refresh the supporting slots, refine and gate in one
        ``fused_frame_step``, which reads from the card once at its end (and
        once per LM iteration for the stop flags)."""
        t0 = time.perf_counter()
        with self.timer.stage("fused_frame"):
            supp = self.frontend.process_to_supp_kf(frame["image"], frame["intrinsics"])
            trg_image = self._tensor(supp["image"])
            i = self.num_kfs - 1
            t = self.config.alignment.track
            prev = self.tracked[-1] if self.tracked else None
            # the supp refinement's connectivity, from the refreshed mirror
            self.supp_valid_host[i] = False
            self.supp_valid_host[i, 0] = True
            self.supp_valid_host[i, 1] = prev is not None
            slots = mapper.build_slots(self.num_kfs, self.window_size, self.supp_valid_host,
                                       "supp")
            do_supp = self.config.alignment.mapping.continual_steps > 0
            res = fused_frame_step(
                self.buffers, i, trg_image, self._tensor(self.current_track),
                self._tensor(self.current_aff), prev.image if prev else None,
                self._tensor(prev.pose) if prev else None,
                self._tensor(prev.affine) if prev else None,
                slots.trg_index[i], slots.trg_valid[i], self._geo_dims(),
                self._track_levels(), t.pyramid_min, t.pyramid_max,
                max_iters=t.gn_max_iters, use_affine=bool(self.affine_compensation),
                do_supp=do_supp, kf_pyramid=self._kf_track_pyramid(), timer=self.timer)
            self._host_ld_dirty = True
        out = res.packed
        self.gn_iters["track"] += res.track_iters
        if do_supp:
            self.gn_iters["supp"].append(res.supp_iters)
        T_frame = out[:16].reshape(4, 4).astype(np.float32)
        affine = out[16:18].astype(np.float32)
        self._last_gate = (float(out[18]), float(out[19]), float(out[20]))
        self.current_track = T_frame
        self.current_aff = affine
        self.current_ts = timestamp
        self.tracked.append(TrackedFrame(timestamp, trg_image, T_frame, affine.copy()))
        self.global_track_trajectory[timestamp] = T_frame
        print(f"tracking time {time.perf_counter() - t0:.3f} sec (fused), tracking loss = "
              f"{float(out[21]):.4f}", flush=True)
        return {"pose": T_frame, "affine": affine, "ts": timestamp}

    def _sync_host_logdepth(self):
        """Refresh the host keyframes' log-depth copies after fused updates
        (lazily: only the host's readers need them)."""
        if not self._host_ld_dirty:
            return
        lds = to_host(self.buffers.kp_logdepth)
        for i in range(self.num_kfs):
            n_i = self.host_kfs[i].kp_logdepth.shape[0]
            self.host_kfs[i].kp_logdepth = lds[i, :n_i]
        self._host_ld_dirty = False

    # ------------------------------------------------------------- mapping
    def _refresh_latest_supp_from_tracked(self):
        """The last two tracked frames become the newest keyframe's
        supporting slots."""
        i = self.num_kfs - 1
        window.clear_supporting(self.buffers, i)
        self.supp_valid_host[i] = False
        n = len(self.tracked)
        for j, k in enumerate(sorted({k for k in (n - 1, n - 2) if 0 <= k < n})):
            tf = self.tracked[k]
            window.set_supporting_slot(self.buffers, i, j, tf.image, tf.pose, tf.affine)
            self.supp_valid_host[i, j] = True

    def _flush_tracked_to_prev_kf(self):
        """Subsampled tracked frames attach to the (still) newest keyframe
        before the new one is added."""
        n = len(self.tracked)
        each_n = self.config.alignment.mapping.supp_every_n
        ids = sorted({i * (n - 1) // each_n + 1 for i in range(1, each_n)})
        ids = [i for i in ids if 0 <= i < n]
        i = self.num_kfs - 1
        window.clear_supporting(self.buffers, i)
        self.supp_valid_host[i] = False
        for j, k in enumerate(ids[: self.supp_cap]):
            tf = self.tracked[k]
            window.set_supporting_slot(self.buffers, i, j, tf.image, tf.pose, tf.affine)
            self.supp_valid_host[i, j] = True

    def mapping(self, num_iters: int, mode: str = "map"):
        assert mode in ("init", "map", "supp")
        if mode != "supp":
            self._last_gate = None  # the poses move: the fused gating is stale
        t0 = time.perf_counter()
        map_cfg = self.config.alignment.mapping
        cost_note = ""
        with self.timer.stage(f"mapping_{mode}"):
            if mode == "init":
                window.clear_supporting(self.buffers)
                self.supp_valid_host[:] = False
                self.tracked = []
            elif self.initialised:
                self._refresh_latest_supp_from_tracked()
            slots = mapper.build_slots(self.num_kfs, self.window_size, self.supp_valid_host, mode)
            geo = self._geo_dims()
            if mode == "supp":
                i = self.num_kfs - 1
                if map_cfg.solver == "gn":
                    ld, _, iters = mapper.run_supp_refinement_gn(
                        self.buffers, i, slots.trg_index[i], slots.trg_valid[i],
                        bool(self.affine_compensation), geo)
                    self.gn_iters["supp"].append(iters)
                else:
                    ld = mapper.run_supp_refinement(
                        self.buffers, i, slots.trg_index[i], slots.trg_valid[i], 1e-2,
                        num_iters, bool(self.affine_compensation), geo)
                self.buffers.kp_logdepth[i] = ld
                n_i = self.host_kfs[i].kp_logdepth.shape[0]
                self.host_kfs[i].kp_logdepth = to_host(ld[:n_i])
                self._update_track_pose()
                self.initialised = True
                return
            masks = mapper.build_masks(
                self.num_kfs, self.window_size, self.supp_valid_host, mode,
                self.window_size, self.opt_supporting, self.affine_compensation)
            if map_cfg.solver == "gn":
                res = gn_mapping(
                    self.buffers, slots.trg_index, slots.trg_valid, slots.src_valid,
                    masks.xi_mask, masks.ld_mask, masks.affine_mask, geo,
                    max_iters=map_cfg.gn_max_iters, use_affine=bool(self.affine_compensation),
                    drag_supporting=not self.opt_supporting,
                    point_stride=map_cfg.gn_point_stride,
                    # mono init's global-scale null direction lets LM's damping
                    # follow float32 noise; pin the gauge (the frozen first
                    # pose is the identity there)
                    pin_scale_gauge=(mode == "init" and bool(self.mono_init)))
                result = mapper.MapResult(poses=res.poses, kp_logdepth=res.kp_logdepth,
                                          affine=res.affine, losses=[],
                                          num_iters=res.num_iters)
                self.gn_iters[mode].append(res.num_iters)
                c0, c1 = to_host(torch.stack([res.initial_cost, res.final_cost]))
                cost_note = f", cost {c0:.5f} -> {c1:.5f}"
            else:
                lr_pose = 1e-2 if (mode == "init" and self.mono_init) else 1e-4
                result = mapper.run_mapping(
                    self.buffers, slots, masks, lr_pose, 1e-2, 1e-5, num_iters,
                    self.initialised, bool(self.affine_compensation), geo,
                    drag_supporting=not self.opt_supporting)
            mapper.write_back(self.buffers, result)
            poses = to_host(self.buffers.poses)
            lds = to_host(self.buffers.kp_logdepth)
            for i in range(self.num_kfs):
                self.host_kfs[i].pose = poses[i]
                n_i = self.host_kfs[i].kp_logdepth.shape[0]
                self.host_kfs[i].kp_logdepth = lds[i, :n_i]
                self.global_kf_trajectory[self.host_kfs[i].timestamp] = poses[i]
            self._host_ld_dirty = False
            self._update_track_pose()
        print(f"Mapping[{mode}] time {time.perf_counter() - t0:.3f} sec "
              f"({result.num_iters} iters{cost_note})", flush=True)
        self.initialised = True

    def _update_track_pose(self):
        """Continue tracking from the newest refined pose: the latest
        supporting frame if newer than the last keyframe."""
        latest_kf_ts = int(self.host_kfs[-1].timestamp)
        i = self.num_kfs - 1
        supp_valid = self.supp_valid_host[i]
        b = self.buffers
        if self.tracked and supp_valid.any() and int(self.tracked[-1].timestamp) > latest_kf_ts:
            j = int(supp_valid.nonzero()[0][-1])
            self.current_track = to_host(b.supp_poses[i, j])
            self.current_aff = to_host(b.supp_affine[i, j])
        else:
            self.current_track = to_host(b.poses[i])
            self.current_aff = to_host(b.affine[i])
            self.current_ts = self.host_kfs[-1].timestamp

    # ------------------------------------------------------------- gating
    def is_kf(self, timestamp: str):
        start_id = self.config.dataset.start_id
        num_init = self.config.alignment.init_frames
        if int(timestamp) - start_id < num_init and not self.initialised:
            return False, None
        if int(timestamp) - start_id == num_init and not self.initialised:
            return True, None
        if self._last_gate is not None:
            validity_ratio, diff, scale = self._last_gate
            self._last_gate = None
        else:
            with self.timer.stage("gating"):
                gate = kf_criteria.gating_tensors(self.buffers, self.num_kfs - 1,
                                                  self._tensor(self.current_track),
                                                  self._geo_dims())
                validity_ratio, diff, scale = (float(v) for v in to_host(gate))
        is_kf = False
        if validity_ratio < self.config.kf.depth_validity_ratio:
            is_kf = True
            print(f"new kf: low depth validity ratio {validity_ratio:.3f}")
        if diff > self.config.kf.translation_thresh:
            is_kf = True
            print(f"new kf: large pose diff {diff:.3f}")
        return is_kf, scale

    # -------------------------------------------------- checkpoint / resume
    def save_state(self, tag: Optional[str] = None) -> str:
        """Checkpoint: the window's host keyframes under
        ``<save_path>/curr_kfs/<tag>/`` with ``window.txt``, and both
        trajectories and the frame timestamps under ``traj/``."""
        tag = tag or (self.current_ts or "init")
        with self.timer.stage("save_state"):
            self._sync_host_logdepth()
            kf_dir = f"{self.config.save_path}/curr_kfs/{tag}"
            for kf in self.host_kfs:
                io.dump_kf(kf_dir, kf)
            traj_dir = f"{self.config.save_path}/traj"
            io.save_trajectory(traj_dir, self.global_kf_trajectory, tag)
            io.save_trajectory(traj_dir, self.global_track_trajectory, tag, name="track_traj")
            with open(f"{traj_dir}/frame_timestamps_{tag}.json", "w") as f:
                json.dump(self.frame_timestamps, f)
            with open(f"{kf_dir}/window.txt", "w") as f:
                f.write("\n".join(kf.timestamp for kf in self.host_kfs))
        return kf_dir

    def load_state(self, state_path: str, frame_id: int) -> int:
        """Resume from the checkpoint of ``frame_id`` under ``state_path``:
        the window's keyframes go back on the device, the trajectories and
        frame timestamps back on the host; ``run`` continues at
        ``frame_id + 1``.  Supporting frames are not restored."""
        tag = self.id_to_timestamp(frame_id)
        kf_dir = f"{state_path}/curr_kfs/{tag}"
        with open(f"{kf_dir}/window.txt") as f:
            timestamps = [line.strip() for line in f if line.strip()]
        traj_dir = f"{state_path}/traj"
        self.global_kf_trajectory = io.load_trajectory(f"{traj_dir}/kf_traj_{tag}.json")
        self.global_track_trajectory = io.load_trajectory(f"{traj_dir}/track_traj_{tag}.json")
        # the final TUM export needs the frames before the restore
        ts_file = f"{traj_dir}/frame_timestamps_{tag}.json"
        if os.path.exists(ts_file):
            with open(ts_file) as f:
                self.frame_timestamps.update(json.load(f))
        else:  # a checkpoint without the file: read them from the dataset
            for fid in set(self.global_kf_trajectory) | set(self.global_track_trajectory):
                self.frame_timestamps[fid] = float(
                    self.dataset[int(fid)].get("timestamp", int(fid)))
        for ts in timestamps:
            kf = io.load_kf(kf_dir, ts)
            self._ensure_window(kf.regions, kf.image)
            self._put_keyframe(kf)
        self.current_track = self.host_kfs[-1].pose.copy()
        self.current_aff = self.host_kfs[-1].affine.copy()
        self.current_ts = self.host_kfs[-1].timestamp
        self.initialised = len(self.host_kfs) >= 2
        return frame_id

    # ------------------------------------------------------------ main loop
    def run(self, max_frames: Optional[int] = None):
        start_id = self.config.dataset.start_id
        if self.config.restore is not None:
            with self.timer.stage("load_state"):
                start_id = self.load_state(self.config.restore.path,
                                           self.config.restore.frame_id)
        else:
            frame0 = self.dataset[start_id]
            ts0 = self.id_to_timestamp(start_id)
            self.frame_timestamps[ts0] = float(frame0.get("timestamp", start_id))
            pose0 = np.asarray(frame0["T"], np.float32)
            self.current_track = pose0
            self.init_keyframe(frame0, pose0, ts0)

        end = len(self.dataset) if max_frames is None else min(
            len(self.dataset), start_id + max_frames)
        map_cfg = self.config.alignment.mapping
        for frame_id in range(start_id + 1, end):
            frame = self.dataset[frame_id]
            timestamp = self.id_to_timestamp(frame_id)
            self.frame_timestamps[timestamp] = float(frame.get("timestamp", frame_id))
            if self._fused_enabled():
                self.fused_frame(frame, timestamp)
            else:
                self.track_frame(frame, timestamp)
                if self.initialised and map_cfg.continual_steps > 0:
                    self.mapping(map_cfg.continual_steps, mode="supp")

            if self.mapping_scheduled:
                i = self.num_kfs - 1
                if int(self.supp_valid_host[i].sum()) >= 2:
                    self.mapping(map_cfg.steps, mode="map")
                    self.mapping_scheduled = False
                    self.tracked = []
                    window.clear_supporting(self.buffers, i)
                    self.supp_valid_host[i] = False

            kf_flag, _ = self.is_kf(timestamp)
            if kf_flag:
                self._flush_tracked_to_prev_kf()
                self.init_keyframe(frame, self.current_track, timestamp)
                self.tracked = []
                if not self.initialised:
                    self.mapping(map_cfg.init_steps, mode="init")
                else:
                    self.mapping_scheduled = True

            if frame_id > 0 and self.config.save_every > 0 and \
                    frame_id % self.config.save_every == 0:
                self.save_state()
            if self.live_cb is not None:
                with self.timer.stage("live_cb"):
                    self.live_cb(self, frame_id)

        self._sync_host_logdepth()
        traj_dir = self.config.save_path + "/traj"
        io.save_trajectory(traj_dir, self.global_kf_trajectory, "final")
        io.save_trajectory(traj_dir, self.global_track_trajectory, "final", name="track_traj")
        if self.config.save_every > 0:
            self.save_state()
        print("\n[timing]\n" + self.timer.report(), flush=True)
        return self.global_kf_trajectory
