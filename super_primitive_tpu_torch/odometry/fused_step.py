"""The steady-state odometry frame as one function with one fetch.

Port of ``super_primitive_tpu/odometry/fused_step.py``.  One tracked frame
of the GN path, in order:

  1. coarse-to-fine GN/LM tracking against the newest keyframe
     (``solve.gauss_newton.gn_track_frame``, pyramids built here);
  2. the supporting-slot refresh: the previous and the current tracked
     frames become the newest keyframe's supporting slots;
  3. the per-frame 'supp' log-depth GN refinement
     (``mapper.run_supp_refinement_gn``);
  4. the keyframe-gating metrics at the refined state.

The JAX package compiles these into one program to save dispatches.  Here
they run eagerly on the window's device, and the function reads from the
card once at its end: the packed 22 floats that the host's control flow
needs.  The LM loops of steps 1 and 3 also read their stop flag once per
iteration (``utils.timing.host_flag``), so their iteration counts are the
JAX package's; nothing else waits for the card.  Every host value the step
needs is on the device before it starts.

On a window sharded over sp (``parallel.mesh.shard_window``) the tracking,
the supp refinement and the gating render reduce over its group inside
steps 1, 3 and 4, so the step's one fetch reads replicated values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..image import pyramid as pyr
from ..solve.gauss_newton import gn_track_frame
from ..utils import timing
from . import kf_criteria
from .mapper import run_supp_refinement_gn
from .window import WindowBuffers


class FusedResult(NamedTuple):
    packed: np.ndarray         # (22,) T_frame (16), affine (2), validity ratio,
                               # translation gap, median depth, track cost
    kp_logdepth: torch.Tensor  # (N,) the keyframe's refined log-depth row
    track_iters: list          # LM iterations at each tracked level
    supp_iters: int            # GN supp refinement iterations (0 when off)


def fused_frame_step(buffers: WindowBuffers, kf_slot: int, trg_image: torch.Tensor,
                     T_init: torch.Tensor, current_aff: torch.Tensor,
                     prev_img: Optional[torch.Tensor], prev_pose: Optional[torch.Tensor],
                     prev_aff: Optional[torch.Tensor], supp_trg_index: np.ndarray,
                     supp_trg_valid: np.ndarray, geo_dims: tuple[int, int], levels,
                     pyramid_min: int, pyramid_max: int, max_iters: int = 20,
                     use_affine: bool = False, supp_max_iters: int = 6, do_supp: bool = True,
                     kf_pyramid: Optional[list] = None, timer=None) -> FusedResult:
    """Track the frame ``trg_image`` (H, W, C) against keyframe slot
    ``kf_slot``, refresh its supporting slots, refine its log-depths and
    gate, updating ``buffers`` in place.

    ``prev_*`` is the previous tracked frame (None on the first frame after
    a keyframe); ``supp_trg_index``/``supp_trg_valid`` the supp
    refinement's targets (``mapper.build_slots`` in 'supp' mode on the
    refreshed slots); ``levels`` the tracked pyramid levels (coarsest
    first); ``kf_pyramid`` the keyframe's image pyramid if already built.
    ``timer``: a ``StageTimer`` for the sub-stages fused_track, fused_supp
    and fused_gating (each ends in a synchronisation on the card)."""
    i = int(kf_slot)
    bundle = buffers.bundle_at(i)
    T_kf = buffers.poses[i]
    with timing.span(timer, "fused_track"):
        if kf_pyramid is None:
            kf_pyramid = pyr.image_pyramid(buffers.images[i], pyramid_min, pyramid_max)
        trg_pyr = pyr.image_pyramid(trg_image, pyramid_min, pyramid_max)
        T_frame, affine, infos = gn_track_frame(
            bundle, kf_pyramid, trg_pyr, buffers.K[i], buffers.kp_logdepth[i],
            buffers.kp_base[i], T_kf, T_init, buffers.affine[i], current_aff, geo_dims,
            levels=list(levels), max_iters=max_iters, use_affine=use_affine)
        track_cost = infos[-1].final_cost if infos else torch.zeros((), device=T_kf.device)

    with timing.span(timer, "fused_supp"):
        # slots [prev, current] with a previous tracked frame; the first
        # frame after a keyframe fills slot 0 alone
        prev_valid = prev_img is not None
        buffers.supp_images[i, 0] = prev_img if prev_valid else trg_image
        buffers.supp_images[i, 1] = trg_image
        buffers.supp_poses[i, 0] = prev_pose if prev_valid else T_frame
        buffers.supp_poses[i, 1] = T_frame
        buffers.supp_affine[i, 0] = prev_aff if prev_valid else affine
        buffers.supp_affine[i, 1] = affine
        buffers.supp_valid[i] = False
        buffers.supp_valid[i, 0] = True
        buffers.supp_valid[i, 1] = prev_valid
        supp_iters = 0
        if do_supp:
            ld_row, _, supp_iters = run_supp_refinement_gn(
                buffers, i, supp_trg_index, supp_trg_valid, use_affine, geo_dims,
                max_iters=supp_max_iters)
            buffers.kp_logdepth[i] = ld_row
        ld_row = buffers.kp_logdepth[i]

    with timing.span(timer, "fused_gating"):
        gate = kf_criteria.gating_tensors(buffers, i, T_frame, geo_dims)
        packed = timing.to_host(torch.cat([T_frame.reshape(16), affine, gate, track_cost[None]]))
    return FusedResult(packed=packed, kp_logdepth=ld_row,
                       track_iters=[r.num_iters for r in infos], supp_iters=supp_iters)
