"""Entry ``infer_depth``: ``depth_completion.completion.infer_depth(frontend,
image, keypoints, K, sparse_depth, rerun)``, one pass of depth completion,
its dense depth and invalid mask brought to the host.

Each frame's view as for ``process_to_kf``, and a sparse depth of the
cell's ``sparse_points`` pixels of it, drawn from the run's seed; the
sparse pixels are round 1's prompts, as ``DepthCompletion`` forms them.
The cell's ``rerun`` is handed to the program; the reference has no loose
pass, so a cell must set it false.
"""

from __future__ import annotations

import numpy as np

from .. import check
from .process_to_kf import Entry as Keyframe


class Entry(Keyframe):
    def __init__(self, config: dict, workload: dict, seed: int, n_frames: int, n_warm: int,
                 device, marks: list):
        from super_primitive_tpu_torch.depth_completion.completion import infer_depth

        if workload["rerun"]:
            raise ValueError("the reference covers infer_depth's first pass only (rerun false)")
        super().__init__(config, workload, seed, n_frames, n_warm, device, marks)
        self.infer_depth, self.points = infer_depth, workload["sparse_points"]
        H, W = self.depth.shape[1:]
        self.dims = np.asarray([H, W], np.float32)
        # each frame's sparse pixels (flat indices), drawn here; the maps are made per frame
        self.picks = {i: _pick(self.depth[self.view(i)], self.points,
                               np.random.default_rng([seed, 3, i % 2**32]))
                      for i in [-j - 1 for j in range(n_warm)] + list(range(n_frames))}

    def inputs(self, i: int) -> dict:
        depth = self.depth[self.view(i)]
        pick = self.picks[i if i < 0 else i % self.n_frames]
        sd = np.zeros(depth.size, np.float32)
        sd[pick] = depth.reshape(-1)[pick]
        sd = sd.reshape(depth.shape)
        r, c = np.nonzero(sd > 1e-6)
        kps = 2.0 * np.stack([r, c], axis=1).astype(np.float32) / (self.dims - 1) - 1.0
        return {"image": self.images[self.view(i)], "K": self.K, "sparse": sd, "keypoints": kps}

    def __call__(self, i: int, x: dict):
        self.fe.rng = self.frame_rng(i)
        depth, invalid = self.infer_depth(self.fe, x["image"], x["keypoints"], x["K"],
                                          x["sparse"], rerun=False, timer=self.fe.timer)
        return {"depth": depth.cpu().numpy(), "invalid": invalid.cpu().numpy()}


def _pick(depth: np.ndarray, n_points: int, rng: np.random.Generator) -> np.ndarray:
    """``n_points`` flat pixel indices drawn uniformly, without replacement,
    among those of ``depth`` with depth."""
    valid = np.flatnonzero(depth.reshape(-1) > 1e-6)
    return rng.choice(valid, size=n_points, replace=False)


def compare(config: dict, workload: dict, seed: int, frames: dict, device,
            control: bool = False) -> dict:
    """The keyframe's numbers and the completion's
    (``check.completion_numbers``) over the sampled frames, the worst of
    each."""
    rows = check.keyframe_numbers(config, seed, frames, device, control)
    return check.worst(check.completion_numbers(frames, rows, device, control))
