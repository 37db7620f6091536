"""Logit slabs that hold kernel K3 (``ops/phase_counts.py``) to its plain
version where its shortcut could go wrong.

The kernel settles a pixel from its 3x3 window's min and max against the
cutoffs of ``phase_cutoffs`` and forms the interpolants of the rest, so
these cases put windows on, and one float either side of, every cutoff,
mix settled and undecided pixels in one slab, and feed non-finite values.
``k3_cases`` is used by ``tests/test_torch_phase_counts.py`` and by
``chip_smoke.py``; every slab is made on the CPU from ``seed``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.phase_counts import THRESHOLDS, phase_cutoffs

KINDS = ("random", "saturated", "cutoffs", "zeros", "voronoi", "nonfinite")
SATURATED = 400.0  # about the median |logit| of the VO path's SAM rounds


def _blocks(r: np.random.Generator, values: np.ndarray, N: int, S: int, size: int = 4):
    """(N, S, S): constant size x size blocks, each a value drawn from
    ``values``, so block interiors have constant windows and block edges
    mixed ones."""
    nb = -(-S // size)
    pick = r.choice(values.astype(np.float32), size=(N, nb, nb))
    return np.repeat(np.repeat(pick, size, axis=1), size, axis=2)[:, :S, :S]


def _saturated(r: np.random.Generator, N: int, S: int) -> np.ndarray:
    """+-SATURATED on the two sides of a random line through each slab, with
    a +-1 ramp a few pixels wide across it (a SAM mask edge)."""
    v, u = np.mgrid[0:S, 0:S].astype(np.float32)
    ang = r.uniform(0, 2 * np.pi, N).astype(np.float32)
    off = r.uniform(0.3 * S, 0.7 * S, N).astype(np.float32)
    d = (np.cos(ang)[:, None, None] * (u - S / 2) + np.sin(ang)[:, None, None] * (v - S / 2)
         + off[:, None, None] - S / 2)
    return np.clip(d * 3.0, -SATURATED, SATURATED).astype(np.float32)


def _voronoi(r: np.random.Generator, N: int, S: int, s: int, input_hw) -> np.ndarray:
    """The structured fake decoder's Voronoi-margin logits
    (``frontend.fakes._fake_lowres_logits``), three candidates a prompt."""
    from ..frontend.fakes import _fake_lowres_logits

    h, w = (min(int(v), s * S) for v in input_hw)
    n_cells, B = 24, -(-N // 3)
    seeds = torch.from_numpy(np.stack([r.uniform(0, h, n_cells), r.uniform(0, w, n_cells)],
                                      axis=1).astype(np.float32))
    aniso = torch.from_numpy(r.uniform(0.6, 1.6, (n_cells, 2)).astype(np.float32))
    pts = torch.from_numpy(np.stack([r.uniform(0, w, B), r.uniform(0, h, B)],
                                    axis=1).astype(np.float32))
    t_vec = torch.tensor([0.0, 8.0, 24.0])
    logits, _ = _fake_lowres_logits(seeds, aniso, pts, t_vec, 1.0, S, float(s))
    return logits.reshape(3 * B, S, S)[:N].numpy()


def k3_case(kind: str, N: int, S: int, s: int, input_hw, seed: int = 0) -> torch.Tensor:
    """One (N, S, S) float32 CPU slab batch of the given kind."""
    r = np.random.default_rng([seed, KINDS.index(kind), N, S])
    f32 = np.float32
    if kind == "random":  # logits scaled like the fake decoder's margins
        x = r.normal(size=(N, S, S)).astype(f32) * f32(4)
    elif kind == "saturated":  # a mask edge, and one pixel a slab near a threshold
        x = _saturated(r, N, S)
        near = np.array(THRESHOLDS, f32)[r.integers(0, 3, N)]
        near = np.nextafter(near, r.choice([-np.inf, np.inf], N).astype(f32))
        x[np.arange(N), r.integers(0, S, N), r.integers(0, S, N)] = near
    elif kind == "cutoffs":  # windows at every cutoff and one float past it
        cut = np.array(phase_cutoffs(s), f32)
        past = np.concatenate([np.nextafter(cut, f32(-np.inf)), np.nextafter(cut, f32(np.inf))])
        x = _blocks(r, np.concatenate([cut, past, [-SATURATED, SATURATED]]), N, S)
    elif kind == "zeros":  # +-0.0, subnormals, the least normals
        tiny = np.array([0.0, 1e-45, 1.1754942e-38, 1.1754944e-38, 1e-40], f32)
        x = _blocks(r, np.concatenate([tiny, -tiny]), N, S)
    elif kind == "voronoi":
        x = _voronoi(r, N, S, s, input_hw)
    elif kind == "nonfinite":  # NaN and +-inf in saturated slabs, some side by side
        x = _saturated(r, N, S)
        k = max(1, S * S // 512)
        for val in (math.nan, math.inf, -math.inf):
            x[np.arange(N)[:, None], r.integers(0, S, (N, k)), r.integers(0, S, (N, k))] = val
        x[:, S // 2, S // 2: S // 2 + 2] = (math.inf, -math.inf)
    else:
        raise ValueError(f"unknown K3 case {kind!r}")
    return torch.from_numpy(np.ascontiguousarray(x, dtype=f32))
