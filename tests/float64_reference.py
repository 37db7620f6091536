"""The JAX package's solvers in float64: the reference that the port's
float32 results are held to where float32 noise alone moves both packages
further apart than a fixed bound between them allows.

``jax_in_float64(fn)`` runs a JAX function with 64-bit types on float64
copies of its floating arrays and hands its floating outputs back in
float32; ``jax_float64_solvers()`` does that to the JAX odometry loop's
Adam tracking, mapping and supp refinement.  Only the JAX package runs
here, so a defect of the port cannot move the reference.

``near_jax_float64`` holds the port's Adam loop to JAX's float64-solver
loop.  Fixed-step Adam (lr 5e-3) on the L1 cost never settles: its last
iterate rides an oscillation of about the step size, whose phase any
float32 rounding moves, so every float32 run parts from the float64 one.
On the frames of ``test_torch_odometry.test_whole_loop`` and thirty copies
with 0.1% of the pixels one level up (``tests/torch_diagnostics.py adam
--seeds 30``) JAX's float32 loop read up to 2.09e-2 in |log| from its
float64 loop at the largest tracked pose and up to 1.20e-2 at the median
(means 1.02e-2 and 5.5e-3), and the port's float32 loop up to 2.12e-2 and
1.37e-2 (means 1.09e-2 and 6.2e-3): the port parts from float64 about as
far as JAX does.  The bounds, 3e-2 and 2e-2, are 1.4 and 1.7 times JAX's
largest readings.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

from super_primitive_tpu.lie import se3 as jse3
from super_primitive_tpu.odometry import odometry as jodometry

# the port's largest and median distance in |log| from JAX's float64 loop
ADAM_FLOAT64_BOUNDS = (3e-2, 2e-2)


def _cast(tree, dtype):
    """``tree`` with its floating arrays in ``dtype``, other leaves as they are."""
    def leaf(x):
        if isinstance(x, (jax.Array, np.ndarray)) and jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.asarray(x, dtype)
        return x
    return jax.tree_util.tree_map(leaf, tree)


def jax_in_float64(fn):
    def run(*args, **kwargs):
        with jax.enable_x64(True):
            out = fn(*_cast(args, jnp.float64), **_cast(kwargs, jnp.float64))
            return _cast(out, jnp.float32)
    return run


@contextlib.contextmanager
def jax_float64_solvers():
    """JAX's odometry loop with its Adam tracking (``track_frame_fused``),
    mapping and supp refinement run in float64; what the loop keeps between
    calls (poses, log-depths, images) stays float32."""
    with contextlib.ExitStack() as stack:
        for module, name in ((jodometry.tracker, "track_frame_fused"),
                             (jodometry.mapper, "run_mapping"),
                             (jodometry.mapper, "run_supp_refinement")):
            stack.enter_context(mock.patch.object(module, name,
                                                  jax_in_float64(getattr(module, name))))
        yield


def pose_err(A, B):
    return float(np.linalg.norm(np.asarray(jse3.log(
        jnp.asarray(np.linalg.inv(A) @ B, jnp.float32)))))


def near_jax_float64(port: dict, jax_f32: dict, ref: dict):
    """The port's tracked poses within ``ADAM_FLOAT64_BOUNDS`` of ``ref``,
    JAX's float64-solver loop's, at the largest and the median; JAX's
    float32 loop's distances are reported beside them."""
    keys = sorted(ref, key=int)
    assert sorted(port, key=int) == sorted(jax_f32, key=int) == keys
    d_t = [pose_err(port[k], ref[k]) for k in keys]
    d_j = [pose_err(jax_f32[k], ref[k]) for k in keys]
    largest, median = ADAM_FLOAT64_BOUNDS
    assert max(d_t) < largest and np.median(d_t) < median, {"port": d_t, "jax": d_j}
    return d_t, d_j
