"""Sim(3) of the PyTorch port against the JAX package (CPU).

Seeded float32 twists (rotations up to ~1 rad, log-scales up to ~0.9,
and the series branches: zero twist, zero rotation, zero scale, tiny
rotation) go through both packages.  Bounds: ``exp``, ``log``,
``inverse`` and ``scale_of`` within 1e-5 relative to the largest entry
(float32 math in both, in other orders); the round trip ``log(exp(xi))``
within 2e-4 of ``xi`` (``tests/test_lie.py``'s bound); ``T @ inverse(T)``
within 1e-5 of the identity; zero scale reduces to SE(3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_primitive_tpu.lie import sim3 as jsim3
from super_primitive_tpu_torch.lie import se3 as tse3
from super_primitive_tpu_torch.lie import sim3 as tsim3

RTOL = 1e-5


def twists(seed=0, n=64):
    xi = np.random.default_rng(seed).normal(size=(n, 7)).astype(np.float32)
    xi[:, :3] *= 0.6
    xi[:, 6] *= 0.3
    xi[0] = 0.0
    xi[1, :3] = 0.0
    xi[2, 6] = 0.0
    xi[3, :3] = 1e-7
    return xi


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_exp_log_inverse_scale_against_jax(seed):
    xi = twists(seed)
    T = tsim3.exp(torch.from_numpy(xi))
    Tj = np.array(jsim3.exp(jnp.asarray(xi)))
    close(T.numpy(), Tj)
    close(tsim3.log(torch.from_numpy(Tj)).numpy(), np.asarray(jsim3.log(jnp.asarray(Tj))))
    close(tsim3.inverse(torch.from_numpy(Tj)).numpy(),
          np.asarray(jsim3.inverse(jnp.asarray(Tj))))
    close(tsim3.scale_of(torch.from_numpy(Tj)).numpy(),
          np.asarray(jsim3.scale_of(jnp.asarray(Tj))))
    r = np.random.default_rng(seed)
    s, t = r.uniform(0.5, 2, 5), r.normal(size=(5, 3))
    R = Tj[:5, :3, :3].astype(np.float64)
    close(tsim3.from_scale_rot_trans(torch.tensor(s), torch.tensor(R), torch.tensor(t)).numpy(),
          np.asarray(jsim3.from_scale_rot_trans(jnp.asarray(s), jnp.asarray(R), jnp.asarray(t))))


def test_round_trip_inverse_and_scale():
    xi = torch.from_numpy(twists(2))
    T = tsim3.exp(xi)
    np.testing.assert_allclose(tsim3.log(T).numpy(), xi.numpy(), atol=2e-4, rtol=0)
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), T.shape)
    np.testing.assert_allclose((T @ tsim3.inverse(T)).numpy(), eye, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tsim3.scale_of(T).numpy(), np.exp(xi[:, 6].numpy()), rtol=1e-5)
    T0 = tsim3.exp(torch.tensor([0.2, -0.1, 0.3, 0.5, -0.2, 0.1, 0.4]))
    assert abs(float(tsim3.scale_of(T0)) - np.exp(0.4)) <= 1e-5 * np.exp(0.4)


def test_zero_scale_is_se3():
    xi6 = torch.from_numpy(np.random.default_rng(3).normal(size=(8, 6)).astype(np.float32) * 0.5)
    T = tsim3.exp(torch.cat([xi6, torch.zeros(8, 1)], dim=1))
    np.testing.assert_allclose(T.numpy(), tse3.exp(xi6).numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tsim3.exp(torch.zeros(7)).numpy(), np.eye(4), atol=1e-6)
