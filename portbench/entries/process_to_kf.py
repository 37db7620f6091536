"""Entry ``process_to_kf``: ``FrontProcessor.process_to_kf(image, K)``, the
keyframe every VO and SfM run waits on, on one distinct view a frame.

Set-up makes the configuration's synthetic weights on the card, builds the
program's frontend on them (SAM in bf16, the NNET in float32,
``frontend_from_state_dicts``) and renders the views: one for each frame
the window can hold, in an order drawn from the run's seed, and one for
each warm-up frame.  Each frame's prompts come from the frontend's
generator, seeded from the run's seed and the frame's index, so the check
can draw them again.

:class:`Capture` keeps, for the frames the check samples, what the timed
path produced on its way (the SAM encoder's features, each decoder call's
prompts and outputs, the selection's masks, each BiNI composite and the
keyframe), by forward hooks and by wrapping three of the frontend's
functions; on every frame it counts the prompts decoded and the keyframe's
segments.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import check, inputs
from ..counts import frame_ideal_s


class Capture:
    """Observes the frontend ``fe``: on every frame, the prompts decoded
    and the keyframe's segments; while :attr:`on`, what :meth:`start`
    lists."""

    def __init__(self, fe):
        from super_primitive_tpu_torch.frontend import process_frame

        self.on = False
        self.frames: dict[int, dict] = {}
        self.current = None
        self.decoded = 0
        self.segments: list[int] = []
        model = fe.mask_predict_fn.predictor.model
        self._handles = [
            model.image_encoder.register_forward_hook(self._encoder),
            model.prompt_encoder.register_forward_hook(self._prompts),
            model.mask_decoder.register_forward_hook(self._decoder),
        ]
        self._module = process_frame
        self._infer_masks = process_frame.infer_masks
        process_frame.infer_masks = self._masks
        composite = fe._composite_integration

        def composite_kept(handle):
            out = composite(handle)
            if self.on:
                self.current["composites"].append(out)
            return out

        fe._composite_integration = composite_kept
        keyframe = fe.process_to_kf

        def keyframe_kept(*args, **kwargs):
            kf = keyframe(*args, **kwargs)
            self.segments.append(len(kf["regions"]))
            if self.on:
                self.current["keyframe"] = kf
            return kf

        fe.process_to_kf = keyframe_kept

    def start(self, index: int):
        self.current = {"decoder": [], "prompts": [], "composites": []}
        self.frames[index] = self.current
        self.on = True

    def stop(self, output=None):
        """End the frame's observation; what it kept on the device moves to
        the host, so that it holds no device memory through the window."""
        if self.on:
            cur = self.current
            cur["output"] = output
            if "features" in cur:
                cur["features"] = cur["features"].cpu()
            cur["prompts"] = [p.cpu() for p in cur["prompts"]]
            cur["decoder"] = [tuple(t.cpu() for t in out) for out in cur["decoder"]]
        self.on = False

    def _encoder(self, module, args, out):
        if self.on:
            self.current["features"] = out

    def _prompts(self, module, args, out):
        self.decoded += args[0].shape[0]
        if self.on:
            self.current["prompts"].append(args[0][:, 0])

    def _decoder(self, module, args, out):
        if self.on:
            self.current["decoder"].append(out)

    def _masks(self, *args, **kwargs):
        gen = self._infer_masks(*args, **kwargs)
        if self.on:
            self.current["masks"] = gen
        return gen

    def close(self):
        for h in self._handles:
            h.remove()
        self._module.infer_masks = self._infer_masks


class Entry:
    """One run's program and inputs.  Frame ``i >= 0`` shows view
    ``order[i % n_frames]``; warm-up frame ``-j - 1`` shows view
    ``n_frames + j``, which no timed frame shows.  ``marks`` receives the
    set-up's steps as (name, time)."""

    def __init__(self, config: dict, workload: dict, seed: int, n_frames: int, n_warm: int,
                 device, marks: list):
        from super_primitive_tpu_torch.config import load_config
        from super_primitive_tpu_torch.frontend.process_frame import frontend_from_state_dicts

        dev = torch.device(device)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        self.config, self.seed, self.n_frames = config, seed, n_frames
        self.K = np.asarray(config["K"], np.float64)
        sam_sd, nnet_sd = inputs.make_weights(config, dev)
        sync()
        marks.append(("weights", time.perf_counter()))
        self.fe = frontend_from_state_dicts(load_config(config["program"]), sam_sd, nnet_sd, dev)
        del sam_sd, nnet_sd
        sync()
        marks.append(("build", time.perf_counter()))
        H, W = config["image_hw"]
        self.images, self.depth = inputs.views(n_frames + n_warm, H, W, self.K, dev)
        self.order = np.random.default_rng([seed, 1]).permutation(n_frames)
        marks.append(("views", time.perf_counter()))
        self.capture = Capture(self.fe)
        fc = config["program"]["frontend"]
        self._per_frame_s = frame_ideal_s(config["sam"], fc["normals"]["network_dim"], 0)
        self._per_prompt_s = frame_ideal_s(config["sam"], fc["normals"]["network_dim"],
                                           1) - self._per_frame_s

    def view(self, i: int) -> int:
        return self.n_frames - i - 1 if i < 0 else int(self.order[i % self.n_frames])

    def frame_rng(self, i: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, 2, i % 2**32])

    def inputs(self, i: int) -> dict:
        """Frame ``i``'s inputs, on the host."""
        return {"image": self.images[self.view(i)], "K": self.K}

    def __call__(self, i: int, x: dict):
        self.fe.rng = self.frame_rng(i)
        return self.fe.process_to_kf(x["image"], x["K"])

    def set_timer(self, timer):
        self.fe.timer = timer

    def model_s(self) -> float:
        """The least time of the model work of every frame so far at the
        card's peaks (``counts.frame_ideal_s``: the SAM encoder and each
        prompt decoded at the bf16 peak, the NNET at the float32 peak)."""
        return len(self.capture.segments) * self._per_frame_s \
            + self.capture.decoded * self._per_prompt_s

    def summary(self, first: int) -> str:
        """The segments of the keyframes from the ``first``-th call on."""
        s = np.asarray(self.capture.segments[first:])
        if not s.size:
            return "no keyframes"
        return (f"segments a keyframe over {s.size}: min {s.min()} median {np.median(s):g} "
                f"p90 {np.percentile(s, 90):g} max {s.max()}")

    def close(self):
        self.capture.close()
        del self.fe


def compare(config: dict, workload: dict, seed: int, frames: dict, device,
            control: bool = False) -> dict:
    """The keyframe's numbers (``check.keyframe_numbers``) over the sampled
    frames, the worst of each."""
    return check.worst(check.keyframe_numbers(config, seed, frames, device, control))
