"""Monocular visual odometry loop, Adam path.

Port of ``super_primitive_tpu/odometry/odometry.py`` (``Odometry`` without
its GN branches): per frame, track -> per-frame 'supp' mapping ->
scheduled 'map' mapping -> keyframe gating -> keyframe init (with depth
re-initialisation from the rendered depth) -> window roll.  Tracking,
mapping and the depth render run as PyTorch on the loop's device
(``tracker.py``, ``mapper.py``, ``ops/scatter.py``); this file shuffles
slots and timestamps on the host.

The frontend is injected (``process_to_kf(image, K)`` -> host geometry,
``process_to_supp_kf`` -> image only), so the fake SAM/normals frontend and
the GT-depth stub are interchangeable.

Not ported here: ``solver: gn`` for tracking or mapping and the fused GN
frame step (ROADMAP.md, queue 1, item 9), checkpoints (``save_every``,
``restore``, ``dump_kfs``) and the live viewer hook.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Protocol

import numpy as np
import torch

from ..config.schema import Config
from ..cost import photometric as ph
from ..geometry import projection
from ..image import pyramid as pyr
from ..keyframe import build_bundle_np
from ..lie import se3
from ..ops.scatter import render_depth
from ..utils.timing import StageTimer
from . import depth_init, io, kf_criteria, mapper, tracker, window


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy that shares no memory with ``t`` (``.cpu().numpy()`` of a
    CPU tensor would alias the window buffers, which change in place)."""
    return t.detach().cpu().numpy().copy()


def render_kf_depth(buffers: window.WindowBuffers, kf_slot: int, pose: torch.Tensor,
                    geo_dims) -> torch.Tensor:
    """Render keyframe ``kf_slot``'s points into the camera at world pose
    ``pose`` (min z-buffer), an (H, W) depth map."""
    bundle = buffers.bundle_at(kf_slot)
    delta = se3.inverse(pose) @ buffers.poses[kf_slot]
    logd = ph.spread_logdepth(bundle, buffers.kp_logdepth[kf_slot], buffers.kp_base[kf_slot])
    pts = projection.unproject(bundle.uv, torch.exp(logd), buffers.K[kf_slot])
    pts = projection.transform(pts, delta)
    depth, _ = render_depth(pts, buffers.K[kf_slot], geo_dims, valid=bundle.valid)
    return depth


def gating_metrics(buffers: window.WindowBuffers, kf_slot: int, pose: torch.Tensor,
                   geo_dims) -> tuple[float, float, float]:
    """Keyframe gating: render the last keyframe's points at ``pose``; the
    share of valid pixels, the median-depth-scaled translation gap and the
    median depth."""
    depth = render_kf_depth(buffers, kf_slot, pose, geo_dims)
    validity_ratio = torch.mean((depth > 1e-6).to(torch.float32))
    diff, scale = kf_criteria.translation_difference(pose, buffers.poses[kf_slot], depth)
    return tuple(float(v) for v in torch.stack([validity_ratio, diff, scale]).cpu())


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
        if a.track.solver != "adam" or a.mapping.solver != "adam":
            raise NotImplementedError(
                "the GN solvers and the fused GN frame step are not ported yet "
                "(ROADMAP.md, queue 1, item 9); use solver: adam")
        if config.restore is not None or config.save_every > 0 or config.dump_kfs:
            raise NotImplementedError(
                "odometry checkpoints (restore, save_every, dump_kfs) are not ported "
                "yet (ROADMAP.md, queue 1)")
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
        return _host(render_kf_depth(self.buffers, self.num_kfs - 1, self._tensor(pose),
                                     self._geo_dims()))

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

        if self.seg_cap is None:
            # capacities fixed at the first keyframe
            self.seg_cap = max(64, int(np.ceil(N_i * 1.5 / 32) * 32))
            self.point_cap = int(np.ceil(max(int(regions.sum()) * 2, Hg * Wg) / 1024) * 1024)
            self.buffers = window.empty_window(
                self.window_size, self.supp_cap, image.shape[:2], image.shape[2],
                self.seg_cap, self.point_cap, device=self.device)
            self.supp_valid_host = np.zeros((self.window_size, self.supp_cap), bool)

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
                self.host_kfs.pop(0)
                window.roll_window(self.buffers)
                self.supp_valid_host = np.concatenate(
                    [self.supp_valid_host[1:], np.zeros_like(self.supp_valid_host[:1])])
                self.num_kfs -= 1

        slot = self.num_kfs
        with self.timer.stage("kf_slot_put"):
            bundle = build_bundle_np(regions, logdepth, capacity=self.point_cap,
                                     device=self.device)
            kp_base = logdepth[np.arange(N_i), keypoints_rc[:, 0], keypoints_rc[:, 1]]
            window.set_keyframe_slot(self.buffers, slot, image, K, pose, kp_logdepth,
                                     self.current_aff, bundle, kp_base)
        self.supp_valid_host[slot] = False
        self.host_kfs.append(host_kf)
        self.num_kfs += 1
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
            T_frame, affine, losses = tracker.track_frame(
                b.bundle_at(i), self._kf_track_pyramid(), trg_image, b.K[i],
                b.kp_logdepth[i], b.kp_base[i], self._tensor(self.host_kfs[-1].pose),
                self._tensor(self.current_track), b.affine[i], self._tensor(self.current_aff),
                self._geo_dims(), tuple(t.steps), t.lr, t.pyramid_min, t.pyramid_max,
                use_affine=bool(self.affine_compensation),
            )
            final = losses[-1][-1:] if losses else torch.full((1,), float("nan"),
                                                             device=self.device)
            out = _host(torch.cat([T_frame.reshape(16), affine, final]))
        T_frame_np = out[:16].reshape(4, 4)
        self.current_track = T_frame_np
        self.current_aff = out[16:18].copy()
        self.current_ts = timestamp
        self.tracked.append(TrackedFrame(timestamp, trg_image, T_frame_np, self.current_aff.copy()))
        self.global_track_trajectory[timestamp] = T_frame_np
        print(f"tracking time {time.perf_counter() - t0:.3f} sec, tracking loss = "
              f"{float(out[18]):.4f}", flush=True)
        return {"pose": T_frame_np, "affine": self.current_aff, "ts": timestamp}

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
        t0 = time.perf_counter()
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
                ld = mapper.run_supp_refinement(
                    self.buffers, i, slots.trg_index[i], slots.trg_valid[i], 1e-2,
                    num_iters, bool(self.affine_compensation), geo)
                self.buffers.kp_logdepth[i] = ld
                n_i = self.host_kfs[i].kp_logdepth.shape[0]
                self.host_kfs[i].kp_logdepth = _host(ld[:n_i])
                self._update_track_pose()
                self.initialised = True
                return
            masks = mapper.build_masks(
                self.num_kfs, self.window_size, self.supp_valid_host, mode,
                self.window_size, self.opt_supporting, self.affine_compensation)
            lr_pose = 1e-2 if (mode == "init" and self.mono_init) else 1e-4
            result = mapper.run_mapping(
                self.buffers, slots, masks, lr_pose, 1e-2, 1e-5, num_iters,
                self.initialised, bool(self.affine_compensation), geo,
                drag_supporting=not self.opt_supporting)
            mapper.write_back(self.buffers, result)
            poses = _host(self.buffers.poses)
            lds = _host(self.buffers.kp_logdepth)
            for i in range(self.num_kfs):
                self.host_kfs[i].pose = poses[i]
                n_i = self.host_kfs[i].kp_logdepth.shape[0]
                self.host_kfs[i].kp_logdepth = lds[i, :n_i]
                self.global_kf_trajectory[self.host_kfs[i].timestamp] = poses[i]
            self._update_track_pose()
        print(f"Mapping[{mode}] time {time.perf_counter() - t0:.3f} sec "
              f"({result.num_iters} iters)", flush=True)
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
            self.current_track = _host(b.supp_poses[i, j])
            self.current_aff = _host(b.supp_affine[i, j])
        else:
            self.current_track = _host(b.poses[i])
            self.current_aff = _host(b.affine[i])
            self.current_ts = self.host_kfs[-1].timestamp

    # ------------------------------------------------------------- gating
    def is_kf(self, timestamp: str):
        start_id = self.config.dataset.start_id
        num_init = self.config.alignment.init_frames
        if int(timestamp) - start_id < num_init and not self.initialised:
            return False, None
        if int(timestamp) - start_id == num_init and not self.initialised:
            return True, None
        with self.timer.stage("gating"):
            validity_ratio, diff, scale = gating_metrics(
                self.buffers, self.num_kfs - 1, self._tensor(self.current_track),
                self._geo_dims())
        is_kf = False
        if validity_ratio < self.config.kf.depth_validity_ratio:
            is_kf = True
            print(f"new kf: low depth validity ratio {validity_ratio:.3f}")
        if diff > self.config.kf.translation_thresh:
            is_kf = True
            print(f"new kf: large pose diff {diff:.3f}")
        return is_kf, scale

    # ------------------------------------------------------------ main loop
    def run(self, max_frames: Optional[int] = None):
        start_id = self.config.dataset.start_id
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

        traj_dir = self.config.save_path + "/traj"
        io.save_trajectory(traj_dir, self.global_kf_trajectory, "final")
        io.save_trajectory(traj_dir, self.global_track_trajectory, "final", name="track_traj")
        print("\n[timing]\n" + self.timer.report(), flush=True)
        return self.global_kf_trajectory
