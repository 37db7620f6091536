"""Kernel K3 (phase counts) of the PyTorch port against the JAX package.

The counts are integers, so every comparison is exact (max abs error 0):

- the port's plain K3 against ``_phase_upsample_counts`` and against the
  Pallas kernel ``phase_counts_pallas`` in interpret mode, at (3, 128, 128),
  s = 4, input_hw = (503, 491), on random logits and on logits that sit on
  +-1 and 0 or a quarter away from them (every product and sum of such
  values is exact, so the strict ``>`` comparisons decide);
- on logits within a float32 ulp or so of the thresholds (1 + 1e-7 etc.),
  where the interpolants round, the plain K3 still equals
  ``_phase_upsample_counts``; the interpret-mode Pallas kernel rounds them
  differently there and is not held to it;
- a CPU tensor takes the plain version and launches no kernel;
- the CUDA kernel against the plain version (``cuda`` marker: skips without a card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_primitive_tpu_torch.ops import phase_counts as k3

S, s, HW = 128, 4, (503, 491)


def logits(kind: str) -> np.ndarray:
    r = np.random.default_rng({"normal": 0, "grid": 1, "ulp": 2}[kind])
    if kind == "normal":
        return (r.normal(size=(3, S, S)) * 2).astype(np.float32)
    base = r.choice(np.float32([-1.0, 0.0, 1.0]), size=(3, S, S))
    steps = np.float32([0.0, 0.25, -0.25, 0.5]) if kind == "grid" else np.float32([1e-7, -1e-7, 0.0])
    return (base + r.choice(steps, size=(3, S, S))).astype(np.float32)


def port_counts(x):
    return [c.numpy() for c in k3.phase_counts(torch.from_numpy(x), s, HW)]


@pytest.mark.parametrize("kind", ["normal", "grid", "ulp"])
def test_plain_matches_jnp_reference(kind):
    # imported here, so that the cuda-marked test below also collects where
    # flax (which the JAX package's nets import) is not installed
    from super_primitive_tpu.nets.sam.predictor import _phase_upsample_counts

    x = logits(kind)
    hi, lo, area = port_counts(x)
    stab, ref_area = _phase_upsample_counts(jnp.asarray(x), s, jnp.asarray(HW))
    np.testing.assert_array_equal(area, np.asarray(ref_area))
    f32 = np.float32
    np.testing.assert_array_equal(hi.astype(f32) / np.maximum(lo, 1).astype(f32), np.asarray(stab))


@pytest.mark.parametrize("kind", ["normal", "grid"])
def test_plain_matches_pallas_interpret(kind):
    from super_primitive_tpu.ops.pallas_phase_counts import phase_counts_pallas

    x = logits(kind)
    got = port_counts(x)
    want = phase_counts_pallas(jnp.asarray(x), s, jnp.asarray(HW), interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w).astype(np.int32))


def test_region_bounds_counts():
    """Counts stay inside the region: all-positive logits count exactly
    the unpadded pixels."""
    x = np.full((2, S, S), 5.0, np.float32)
    hi, lo, area = port_counts(x)
    assert (area == HW[0] * HW[1]).all() and (hi == area).all() and (lo == area).all()


def test_cpu_tensor_takes_plain_version():
    k3.reset_launch_counts()
    x = torch.from_numpy(logits("normal"))
    for a, b in zip(k3.phase_counts(x, s, HW), k3.phase_counts_reference(x, s, HW)):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    assert k3.launch_counts["phase_counts"] == 0


@pytest.mark.cuda
class TestKernelOnCard:
    """Run with ``python -m pytest tests/test_torch_phase_counts.py -m cuda``
    on a machine with a card; skips elsewhere."""

    def test_kernel_matches_plain_version(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        for kind in ("normal", "grid", "ulp"):
            x = torch.from_numpy(logits(kind)).cuda()
            got = k3.phase_counts(x, s, HW)
            want = k3.phase_counts_reference(x, s, HW)
            for g, w in zip(got, want):
                assert torch.equal(g, w), kind
