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
- the cutoffs of the kernel's shortcut (``phase_cutoffs``), by a scan of
  the floats around each and of every subnormal for t = 0;
- the shortcut's math: a test-only model that settles pixels from their
  3x3 window's min and max and the cutoffs, and forms the interpolants of
  the rest, equals the plain version on the adversarial cases of
  ``eval/k3_cases.py``;
- the launch plan refuses what the kernel does not take;
- the CUDA kernel against the plain version (``cuda`` marker: skips without
  a card), on those cases with NaN and +-inf added, at N 1, 96 and 384,
  S 128 and 256, input_hw (768, 1024) and (503, 491).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_primitive_tpu_torch.eval.k3_cases import KINDS, k3_case
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


def ordered_key(v: float) -> int:
    """The float32 v's position among the ordered floats (-0.0 just below
    +0.0): the inverse of ``phase_counts._key_floats``."""
    b = int(np.float32(v).view(np.uint32))
    return b if b < 0x80000000 else -(b & 0x7FFFFFFF) - 1


def scan_cutoffs(s: int, keys: np.ndarray):
    """For each float of ``keys``: every phase above t, and no phase above
    t, for t = -1, 0, +1 (each (3, len(keys)) bool)."""
    v = k3.constant_interpolants(k3._key_floats(keys), s)
    t = torch.tensor(k3.THRESHOLDS)[:, None, None]
    return (v[None] > t).all(-1).numpy(), (v[None] <= t).all(-1).numpy()


@pytest.mark.parametrize("s", [2, 4])
def test_cutoffs_by_scan(s):
    """Every float within 3000 of each cutoff: m >= c_t puts every phase
    above t and the float below c_t does not; m <= d_t puts no phase above
    t and the float above d_t does."""
    cut = k3.phase_cutoffs(s)
    for k in range(3):
        kc, kd = ordered_key(cut[k]), ordered_key(cut[3 + k])
        keys = np.arange(kc - 3000, kc + 3001, dtype=np.int64)
        above, _ = scan_cutoffs(s, keys)
        np.testing.assert_array_equal(above[k], keys >= kc)
        keys = np.arange(kd - 3000, kd + 3001, dtype=np.int64)
        _, none_above = scan_cutoffs(s, keys)
        np.testing.assert_array_equal(none_above[k], keys <= kd)


@pytest.mark.parametrize("s", [2, 4])
def test_cutoffs_through_the_subnormals(s):
    """t = 0 across every subnormal of both signs, both zeros and the first
    normals: the cutoffs hold at each step without flushing to zero."""
    cut = k3.phase_cutoffs(s)
    kc, kd = ordered_key(cut[1]), ordered_key(cut[4])
    first_normal = ordered_key(np.finfo(np.float32).tiny)
    for start in range(-first_normal - 64, first_normal + 64, 1 << 21):
        keys = np.arange(start, min(start + (1 << 21), first_normal + 64), dtype=np.int64)
        above, none_above = scan_cutoffs(s, keys)
        np.testing.assert_array_equal(above[1], keys >= kc)
        np.testing.assert_array_equal(none_above[1], keys <= kd)


def shortcut_model(x: torch.Tensor, s: int, hw) -> tuple[list, torch.Tensor]:
    """Test-only model of the kernel's shortcut: a pixel whose clamped 3x3
    window has min >= c_t counts all its region phases for t, one with
    max <= d_t none (both only for a finite window); every other pixel's
    interpolants are formed as the plain version forms them.  Returns the
    (hi, lo, area) counts and the undecided mask."""
    N, S, _ = x.shape
    cut = k3.phase_cutoffs(s)
    xp = torch.nn.functional.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    win = torch.stack([xp[:, a:a + S, b:b + S] for a in range(3) for b in range(3)])
    mn, mx = win.amin(0), win.amax(0)  # NaN propagates
    up = sum((mn >= c).int() for c in cut[:3])
    nb = sum((~(mx <= d)).int() for d in cut[3:])
    settled = (up == nb) & torch.isfinite(mn) & torch.isfinite(mx)
    idx = torch.arange(S)
    ny = torch.clamp(hw[0] - s * idx, 0, s)
    nx = torch.clamp(hw[1] - s * idx, 0, s)
    n = (ny[:, None] * nx[None, :])[None]
    lo, area, hi = (torch.sum(torch.where(settled & (up >= k), n, 0), dim=(1, 2),
                              dtype=torch.int32) for k in (1, 2, 3))
    # the undecided pixels: the plain version's interpolants, per pixel
    xm_r = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    xp_r = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    for ky in range(s):
        f = (ky + 0.5) / s - 0.5
        ry = (1 + f) * x - f * xm_r if f < 0 else (1 - f) * x + f * xp_r
        rym = torch.cat([ry[:, :, :1], ry[:, :, :-1]], dim=2)
        ryp = torch.cat([ry[:, :, 1:], ry[:, :, -1:]], dim=2)
        for kx in range(s):
            g = (kx + 0.5) / s - 0.5
            v = (1 + g) * ry - g * rym if g < 0 else (1 - g) * ry + g * ryp
            reg = ~settled & ((s * idx + ky) < hw[0])[:, None] & ((s * idx + kx) < hw[1])[None, :]
            hi += torch.sum((v > 1.0) & reg, dim=(1, 2), dtype=torch.int32)
            lo += torch.sum((v > -1.0) & reg, dim=(1, 2), dtype=torch.int32)
            area += torch.sum((v > 0.0) & reg, dim=(1, 2), dtype=torch.int32)
    return [hi, lo, area], ~settled


@pytest.mark.parametrize("hw", [(503, 491), (768, 1024)])
@pytest.mark.parametrize("kind", KINDS)
def test_shortcut_math_matches_plain(kind, hw):
    """The shortcut's counts equal the plain version's exactly, at the
    region edge of (503, 491) (partial last row and column) and where the
    region covers the whole slab."""
    x = k3_case(kind, 3, S, s, hw)
    got, undecided = shortcut_model(x, s, hw)
    for g, w in zip(got, k3.phase_counts_reference(x, s, hw)):
        assert torch.equal(g, w), kind
    if kind in ("saturated", "voronoi"):
        # the shortcut is taken: most pixels settle
        assert float(undecided.float().mean()) < 0.5, kind


def test_voronoi_settles_like_the_path():
    """On the fake decoder's margins (the VO path's K3 inputs) about 1% of
    pixels are left undecided."""
    x = k3_case("voronoi", 6, 256, s, (768, 1024))
    _, undecided = shortcut_model(x, s, (768, 1024))
    assert float(undecided[:, :192].float().mean()) < 0.05


@pytest.mark.parametrize("N, S_, s_, hw", [
    (1, 20000, 4, (80000, 80000)),  # three rows overflow shared memory
    (40000, 256, 4, (768, 1024)),   # N * S * S >= 2**31
    (1, 256, 17, (768, 1024)),      # s above 16
    (0, 256, 4, (768, 1024)),
])
def test_launch_plan_refuses(N, S_, s_, hw):
    with pytest.raises(ValueError):
        k3.launch_plan(N, S_, s_, hw)


def test_launch_plan_is_pure_and_fits():
    for N, S_, hw in [(384, 256, (768, 1024)), (96, 256, (768, 1024)), (3, 128, (503, 491))]:
        band, threads = k3.launch_plan(N, S_, s, hw)
        assert (band, threads) == k3.launch_plan(N, S_, s, hw)
        assert threads % 32 == 0 and 32 <= threads <= 512 and band >= 1
        _, C = k3.region_lowres(S_, s, hw)
        assert k3.smem_bytes(S_, band, C) <= 227 * 1024 - 1024


def card_case_params():
    return [pytest.param(kind, N, S_, hw, id=f"{kind}-{N}x{S_}-{hw[0]}x{hw[1]}")
            for kind in KINDS for N in (1, 96, 384) for S_ in (128, 256)
            for hw in ((768, 1024), (503, 491))]


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

    @pytest.mark.parametrize("kind, N, S_, hw", card_case_params())
    def test_kernel_on_adversarial_cases(self, kind, N, S_, hw):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        x = k3_case(kind, N, S_, s, hw).cuda()
        got = k3.phase_counts(x, s, hw)
        want = k3.phase_counts_reference(x, s, hw)
        for name, g, w in zip(("hi", "lo", "area"), got, want):
            assert torch.equal(g, w), (name, int((g - w).abs().max()))

    @pytest.mark.parametrize("layout", ["S126", "S768", "offset"])
    def test_kernel_other_layouts(self, layout):
        """Slabs whose rows are not 16-byte aligned (S = 126, or a storage
        offset) take 4-byte copies; S = 768 needs over 48 KB of shared
        memory a CTA."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        N, S_, hw = {"S126": (7, 126, (503, 491)), "S768": (9, 768, (3072, 3000)),
                     "offset": (7, 128, (503, 491))}[layout]
        if layout == "S768":
            band, _ = k3.launch_plan(N, S_, s, hw)
            assert k3.smem_bytes(S_, band, k3.region_lowres(S_, s, hw)[1]) > 48 * 1024
        for kind in ("voronoi", "nonfinite", "random"):
            x = k3_case(kind, N, S_, s, hw).cuda()
            if layout == "offset":
                buf = torch.empty(x.numel() + 1, device="cuda")
                buf[1:] = x.reshape(-1)
                x = buf[1:].view(x.shape)
            for g, w in zip(k3.phase_counts(x, s, hw), k3.phase_counts_reference(x, s, hw)):
                assert torch.equal(g, w), kind

    def test_launch_refuses_too_little_shared_memory(self):
        """The wrapper passes the shared memory ``smem_bytes`` sizes; the
        launch refuses less than the staged rows and the group queue."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        N, S_, hw = 96, 256, (768, 1024)
        x = k3_case("voronoi", N, S_, s, hw).cuda()
        band, threads = k3.launch_plan(N, S_, s, hw)
        C = k3.region_lowres(S_, s, hw)[1]
        counts = torch.empty((3, N), dtype=torch.int32, device="cuda")

        def launch(smem):
            return k3._lib().phase_counts_launch(
                x.data_ptr(), N, S_, s, hw[0], hw[1], band, threads, smem,
                k3._cutoff_array(s), counts.data_ptr(), torch.cuda.current_stream().cuda_stream)

        rows_and_groups = ((band + 2) * S_ + band * -(-C // 4)) * 4
        assert launch(rows_and_groups - 4) != 0
        # an empty pixel queue: every undecided pixel is formed in place
        assert launch(rows_and_groups) == 0
        want = k3.phase_counts_reference(x, s, hw)
        for g, w in zip(counts, want):
            assert torch.equal(g, w)

    @pytest.mark.parametrize("s_", [1, 2, 3, 5])
    def test_kernel_other_factors(self, s_):
        """The generic-s instantiation (weights rounded from double)."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        hw = (s_ * 120 + 1, s_ * 97 + 3)
        for kind in ("random", "voronoi", "cutoffs", "nonfinite"):
            x = k3_case(kind, 5, 128, s_, hw).cuda()
            for g, w in zip(k3.phase_counts(x, s_, hw), k3.phase_counts_reference(x, s_, hw)):
                assert torch.equal(g, w), kind
