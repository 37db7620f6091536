"""Retraction Adam, in accumulate mode and in fold mode.

Port of ``super_primitive_tpu/solve/retraction_adam.py``.

- Accumulate mode (two-frame SfM): the parameters are per-frame SE(3)
  tangent vectors ``xi`` around fixed base poses (pose = base @ exp(xi))
  and per-segment scalar log-depths, stepped by ``torch.optim.Adam`` with
  per-group learning rates.
- Fold mode (odometry tracking and mapping): every step the pose update
  folds into the pose (pose <- retract(pose, -lr * direction)) and the
  tangent restarts at zero while its Adam moments persist.  The direction
  is :class:`ScaleByAdam`'s, the counterpart of ``optax.scale_by_adam``
  that the JAX package's tracker and mapper use, with the learning rates
  (pose, log-depth, affine brightness) applied by the caller.

optax's adam and ``torch.optim.Adam`` share the update law (b1=0.9,
b2=0.999, eps=1e-8 outside the sqrt, bias correction); the two round
differently in the last bits.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..lie import se3


class OptParams(NamedTuple):
    """Optimizable state.  ``poses`` (B, 4, 4) are the fixed base poses,
    ``xi`` (B, 6) the accumulated tangents, ``kp_logdepth`` (N,) the
    per-segment scalars."""

    poses: torch.Tensor
    xi: torch.Tensor
    kp_logdepth: torch.Tensor


def make_optimizer(params: OptParams, lr_depth: float, lr_pose: float) -> torch.optim.Adam:
    """Per-group Adam over ``xi`` and ``kp_logdepth`` (two-frame lrs:
    depth 1e-3, pose 1e-2)."""
    params.xi.requires_grad_(True)
    params.kp_logdepth.requires_grad_(True)
    return torch.optim.Adam(
        [
            {"params": [params.xi], "lr": lr_pose},
            {"params": [params.kp_logdepth], "lr": lr_depth},
        ]
    )


def current_poses(params: OptParams) -> torch.Tensor:
    """Pose estimates including the accumulated tangent: base @ exp(xi)."""
    return params.poses @ se3.exp(params.xi)


def run_adam(
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    params: OptParams,
    optimizer: torch.optim.Adam,
    num_steps: int,
    skip_first_step: bool = False,
) -> torch.Tensor:
    """Run ``num_steps`` of Adam on ``loss_fn(poses, kp_logdepth)``, updating
    ``params.xi`` and ``params.kp_logdepth`` in place.  Returns the losses
    (num_steps,) on the parameters' device, with no host sync per step.

    ``skip_first_step`` reproduces the reference's viz-only first iteration:
    its loss is recorded but there is no step and no moment update."""
    losses = torch.empty(num_steps, device=params.xi.device)
    for i in range(num_steps):
        optimizer.zero_grad()
        loss = loss_fn(current_poses(params), params.kp_logdepth)
        losses[i] = loss.detach()
        if skip_first_step and i == 0:
            continue
        loss.backward()
        optimizer.step()
    return losses


class ScaleByAdam:
    """The Adam direction m_hat / (sqrt(v_hat) + eps) of a list of tensors,
    without a learning rate (``optax.scale_by_adam``).  Moments live on the
    tensors' device and persist across :meth:`direction` calls."""

    def __init__(self, like: list[torch.Tensor], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(t) for t in like]
        self.nu = [torch.zeros_like(t) for t in like]
        self.count = 0

    def direction(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        out = []
        for mu, nu, g in zip(self.mu, self.nu, grads):
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            out.append((mu / c1) / (torch.sqrt(nu / c2) + self.eps))
        return out
