"""The SAM encoder's attention lowerings and kernel K4 (extended-head
attention) of the PyTorch port against the JAX package, on the CPU in
float32; inputs and weights from numpy seeds.

- ``extended_qk`` equals JAX's on 4x6 and 6x4 grids (a transposed row /
  column one-hot would hide on a square one), to 1e-6;
- ``Attention`` under "xla", "ext" and "flash" (K4's plain version on the
  CPU) against JAX's ``Attention(impl="xla")`` on the same converted
  parameters with non-zero rel-pos tables, on 4x6 and 5x3 grids, to rtol /
  atol 1e-5 (JAX's own bound between its lowerings); the JAX package's
  TPU layout and profiling lowerings ("ext_hp", "skip") raise here;
- the encoder under the port's lowering options and their combinations
  against JAX's ``ImageEncoderViT`` on the base (materialised-bias,
  per-block partition) lowering, to rtol / atol 2e-5 (JAX's bound between
  its options), on a config whose 4x4 token grid pads to 6x6 windows;
- the bf16 ``SamPredictor`` picks the encoder fields JAX's does;
- ``ext_attention`` on CPU tensors is its plain version and launches
  nothing, its plain version equals a float64 softmax in numpy, and an
  unknown lowering or device raises;
- zero lanes padded onto q_ext, k_ext and v (as the wrapper pads the bf16
  kernel's widths to a multiple of 8) change nothing, bit for bit;
- K4 on the card against its plain version (``cuda`` marker: skips
  without a card) at the tiny config's, a ragged and ViT-H's shapes, and
  at the edges the bf16 body's tiles must mask.

JAX is imported inside the tests that use it, so that the ``cuda`` test
collects on a machine without it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from super_primitive_tpu_torch.nets import synth as tsynth
from super_primitive_tpu_torch.nets.sam import image_encoder as tie
from super_primitive_tpu_torch.nets.sam.predictor import SamPredictor as TPredictor
from super_primitive_tpu_torch.nets.sam.predictor import build_sam
from super_primitive_tpu_torch.ops import attention as k4

# JAX's test_persistent_windows_and_windowed_ext_parity config: a 4x4
# token grid, window 3 (padded to 6x6), global attention at block 2
PADDED = dict(depth=4, window_size=3, global_attn_indexes=(2,))
ENCODER_OPTIONS = {
    "persistent": {"persistent_windows": True},
    "windowed_ext": {"windowed_attn_impl": "ext"},
    "persistent_windowed_ext": {"persistent_windows": True, "windowed_attn_impl": "ext"},
    "global_ext": {"global_attn_impl": "ext"},
    "global_flash": {"global_attn_impl": "flash"},
    # the bf16 predictor's lowering (without its tanh GELU), and K4 inside it
    "all_ext_persistent": {"persistent_windows": True, "windowed_attn_impl": "ext",
                           "global_attn_impl": "ext"},
    "flash_windowed_ext_persistent": {"persistent_windows": True, "windowed_attn_impl": "ext",
                                      "global_attn_impl": "flash"},
}


def jax_modules():
    import jax
    import jax.numpy as jnp

    from super_primitive_tpu.nets.sam import image_encoder as jie

    return jax, jnp, jie


def attention_params(H, W, C, seed):
    """numpy weights of one attention layer (JAX layout: kernels (in, out))
    with non-zero rel-pos tables."""
    r = np.random.default_rng(seed)
    hd = C // 2
    f = lambda *s: (0.3 * r.normal(size=s)).astype(np.float32)  # noqa: E731
    return {"qkv": {"kernel": f(C, 3 * C), "bias": f(3 * C)},
            "proj": {"kernel": f(C, C), "bias": f(C)},
            "rel_pos_h": f(2 * H - 1, hd), "rel_pos_w": f(2 * W - 1, hd)}


def port_attention(p, C, hw, impl):
    m = tie.Attention(C, 2, hw, impl)
    m.load_state_dict({
        "qkv.weight": torch.from_numpy(p["qkv"]["kernel"].T.copy()),
        "qkv.bias": torch.from_numpy(p["qkv"]["bias"]),
        "proj.weight": torch.from_numpy(p["proj"]["kernel"].T.copy()),
        "proj.bias": torch.from_numpy(p["proj"]["bias"]),
        "rel_pos_h": torch.from_numpy(p["rel_pos_h"]),
        "rel_pos_w": torch.from_numpy(p["rel_pos_w"])})
    return m.eval().requires_grad_(False)


@pytest.mark.parametrize("H,W", [(4, 6), (6, 4)])
def test_extended_qk_equals_jax(H, W):
    _, jnp, jie = jax_modules()
    C, B = 16, 3
    r = np.random.default_rng(0)
    q, k = (r.normal(size=(B, H * W, C)).astype(np.float32) for _ in range(2))
    rh, rw = (r.normal(size=(2 * n - 1, C)).astype(np.float32) for n in (H, W))
    want = jie.extended_qk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(rh), jnp.asarray(rw),
                           (H, W), C ** -0.5)
    got = tie.extended_qk(*map(torch.from_numpy, (q, k, rh, rw)), (H, W), C ** -0.5)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, H * W, C + H + W)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw", [(4, 6), (5, 3)])
@pytest.mark.parametrize("impl", ["xla", "ext", "flash"])
def test_attention_matches_jax(impl, hw):
    _, jnp, jie = jax_modules()
    (H, W), C = hw, 16
    p = attention_params(H, W, C, seed=3)
    x = np.random.default_rng(4).normal(size=(2, H, W, C)).astype(np.float32)
    want = jie.Attention(2, input_size=(H, W), impl="xla").apply(
        {"params": p}, jnp.asarray(x))
    before = k4.launch_counts["ext_attention"]
    got = port_attention(p, C, (H, W), impl)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert k4.launch_counts["ext_attention"] == before


@pytest.mark.parametrize("impl", ["mosaic", "ext_hp", "skip"])
def test_attention_refuses_unknown_impl(impl):
    with pytest.raises(ValueError, match="unknown attention impl"):
        tie.Attention(16, 2, (4, 4), impl)


@pytest.fixture(scope="module")
def padded_encoder():
    """(state dict at a trained net's scale, input image, JAX's base encoder
    output) for the padded config."""
    jax, jnp, jie = jax_modules()
    from super_primitive_tpu.nets import convert as jconvert

    jcfg = dataclasses.replace(jie.VIT_TINY_TEST, **PADDED)
    sd = tsynth.scale_like_trained(tsynth.synth_sam_state_dict(jcfg))
    tree = jax.tree.map(jnp.asarray, jconvert.convert_sam(sd, depth=jcfg.depth))
    x = np.random.default_rng(1).normal(size=(1, jcfg.img_size, jcfg.img_size, 3))
    x = x.astype(np.float32)
    want = np.asarray(jie.ImageEncoderViT(jcfg).apply({"params": tree["image_encoder"]}, x))
    return sd, x, want


@pytest.mark.parametrize("option", sorted(ENCODER_OPTIONS))
def test_encoder_lowering_matches_jax(padded_encoder, option):
    sd, x, want = padded_encoder
    cfg = dataclasses.replace(tie.VIT_TINY_TEST, **PADDED, **ENCODER_OPTIONS[option])
    S = cfg.img_size // cfg.patch_size
    assert S % cfg.window_size != 0  # the windowed blocks pad
    got = build_sam(sd, cfg, "cpu").image_encoder(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5, err_msg=option)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_bf16_predictor_picks_jax_fields(impl):
    jax, jnp, jie = jax_modules()
    from super_primitive_tpu.nets import convert as jconvert
    from super_primitive_tpu.nets.sam.predictor import SamPredictor as JPredictor

    jcfg = dataclasses.replace(jie.VIT_TINY_TEST, global_attn_impl=impl)
    tcfg = dataclasses.replace(tie.VIT_TINY_TEST, global_attn_impl=impl)
    sd = tsynth.synth_sam_state_dict(tcfg)
    tree = jax.tree.map(jnp.asarray, jconvert.convert_sam(sd, depth=jcfg.depth))
    jp = JPredictor(tree, jcfg, compute_dtype=jnp.bfloat16)
    tp = TPredictor(sd, tcfg, compute_dtype=torch.bfloat16, device="cpu")
    fields = ("global_attn_impl", "windowed_attn_impl", "persistent_windows", "gelu_approx")
    assert {f: getattr(tp.cfg, f) for f in fields} == {f: getattr(jp.cfg, f) for f in fields}
    assert TPredictor(sd, tcfg, device="cpu").cfg == tcfg  # float32 keeps the caller's
    blocks = tp.model.image_encoder.blocks
    g = tcfg.global_attn_indexes[0]
    assert blocks[g].attn.impl == jp.cfg.global_attn_impl
    assert blocks[0].attn.impl == jp.cfg.windowed_attn_impl
    assert blocks[0].pre_windowed == jp.cfg.persistent_windows


def test_plain_equals_float64_softmax():
    r = np.random.default_rng(5)
    q, k = (r.normal(size=(3, 37, 26)).astype(np.float32) for _ in range(2))
    v = r.normal(size=(3, 37, 16)).astype(np.float32)
    s = q.astype(np.float64) @ k.astype(np.float64).transpose(0, 2, 1)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = (p / p.sum(-1, keepdims=True)) @ v.astype(np.float64)
    before = k4.launch_counts["ext_attention"]
    got = k4.ext_attention(*map(torch.from_numpy, (q, k, v)))
    assert k4.launch_counts["ext_attention"] == before
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    got16 = k4.ext_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got16.dtype == torch.bfloat16
    # float32 inside, one bf16 rounding out
    q16, k16, v16 = (torch.from_numpy(a).bfloat16().double().numpy() for a in (q, k, v))
    s16 = q16 @ k16.transpose(0, 2, 1)
    p16 = np.exp(s16 - s16.max(-1, keepdims=True))
    want16 = (p16 / p16.sum(-1, keepdims=True)) @ v16
    np.testing.assert_allclose(got16.float().numpy(), want16, rtol=8e-3, atol=8e-3)


def test_no_kernel_for_other_devices():
    q = torch.empty(2, 8, 26, device="meta")
    v = torch.empty(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        k4.ext_attention(q, q, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_lane_padding_is_exact(dtype):
    r = np.random.default_rng(7)
    q, k = (torch.from_numpy(r.normal(size=(3, 37, 26)).astype(np.float32)).to(dtype)
            for _ in range(2))
    v = torch.from_numpy(r.normal(size=(3, 37, 12)).astype(np.float32)).to(dtype)
    pad = torch.nn.functional.pad
    got = k4.ext_attention_reference(pad(q, (0, 6)), pad(k, (0, 6)), pad(v, (0, 4)))
    want = k4.ext_attention_reference(q, k, v)
    assert torch.equal(got[..., :12], want)
    assert not got[..., 12:].any()


# K4's float32 check: its distance from the float64 function, relative to
# the latter's max, within K4_F64_TOL = (factor, floor) of the plain
# version's: factor x plain + floor (chip_smoke.py holds the card to it)
K4_F64_TOL = (2.0, 1e-6)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: the low 13 mantissa
    bits dropped, to nearest with ties away from zero (on the int32 view,
    the magnitude is the low 31 bits whatever the sign)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _emulated_k4(q, k, v, products: int) -> torch.Tensor:
    """K4's float32 arithmetic on the CPU: both products from TF32 halves,
    3 products (hi lo + lo hi, then hi hi: the kernel's 3xTF32) or 1 (hi
    hi: plain TF32), each summed in float32; softmax in float32."""
    def mm(a, b):
        (ah, al), (bh, bl) = _split(a), _split(b)
        if products == 1:
            return ah @ bh
        return (ah @ bl + al @ bh) + ah @ bh
    p = mm(q, k.transpose(-2, -1).contiguous()).softmax(dim=-1)
    return mm(p, v)


def test_tf32_rounding_emulates_cvt_rna():
    """Ties go away from zero, either sign; below a tie goes down; the
    halves of 1/3 add up to it within 2^-22."""
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11), 1 + 2**-11 - 2**-23, 0.0])
    want = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0, 0.0])
    assert torch.equal(_tf32(x), want)
    hi, lo = _split(torch.tensor([1 / 3], dtype=torch.float32))
    assert abs(float(hi.double() + lo.double()) - float(np.float32(1 / 3))) <= 2**-22 / 3


@pytest.mark.parametrize("products,passes", [(3, True), (1, False)])
def test_split_products_meet_the_float64_check(products, passes):
    """The 3xTF32 split of both products at ViT-H's widths (208 / 80; BH and
    L cut to 1 x 1024) stays within K4_F64_TOL of the plain version's
    distance from float64; one TF32 product does not, so the check can
    fail."""
    r = np.random.default_rng(15)
    q, k = (torch.from_numpy(0.3 * r.normal(size=(1, 1024, 208)).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(r.normal(size=(1, 1024, 80)).astype(np.float32))
    exact = (q.double() @ k.double().transpose(-2, -1)).softmax(-1) @ v.double()
    scale = exact.abs().max()
    got = _emulated_k4(q, k, v, products)
    err, plain = (float((t.double() - exact).abs().max() / scale)
                  for t in (got, k4.ext_attention_reference(q, k, v)))
    factor, floor = K4_F64_TOL
    assert (err <= factor * plain + floor) == passes, (products, err, plain)


# (BH, L, D_qk, D_v) of the card test: the tiny config's, a ragged and
# ViT-H's shapes, then the edges of the bf16 body's tiles: L of 1 and 130
# (a partial key tile, a partial query tile), D_qk of 26, 200 and 256
# (padded lanes, a half k-step, four full boxes), D_v of 16 and 128, BH 1
CARD_SHAPES = ((2, 16, 24, 8), (3, 1000, 208, 80), (16, 4096, 208, 80),
               (2, 1, 208, 80), (2, 130, 208, 80), (2, 130, 26, 16), (2, 130, 200, 80),
               (2, 130, 256, 128), (2, 257, 208, 16), (1, 300, 208, 128), (1, 4096, 208, 80))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Run with ``python -m pytest tests/test_torch_attention.py -m cuda``
    on a machine with a card: K4 at ``CARD_SHAPES``, each launch counted
    once.  float32: K4's distance from the
    float64 function, relative to its max, within twice the plain
    version's plus 1e-6 (a kernel that rounds to bf16 inside lands near
    2e-3); bf16: within 8e-3 of max|plain| (two bf16 roundings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = np.random.default_rng(6)
    for BH, L, dqk, dv in CARD_SHAPES:
        q, k = (torch.from_numpy(0.3 * r.normal(size=(BH, L, dqk)).astype(np.float32)).cuda()
                for _ in range(2))
        v = torch.from_numpy(r.normal(size=(BH, L, dv)).astype(np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            a = [t.to(dtype) for t in (q, k, v)]
            before = k4.launch_counts["ext_attention"]
            got = k4.ext_attention(*a)
            torch.cuda.synchronize()
            assert k4.launch_counts["ext_attention"] == before + 1
            assert got.dtype == dtype and got.shape == (BH, L, dv)
            want = k4.ext_attention_reference(*a)
            if dtype == torch.float32:
                exact = (q.double() @ k.double().transpose(-2, -1)).softmax(-1) @ v.double()
                scale = exact.abs().max()
                err, plain_err = (float((t.double() - exact).abs().max() / scale)
                                  for t in (got, want))
                factor, floor = K4_F64_TOL
                assert err <= factor * plain_err + floor, (BH, L, dqk, dv, err, plain_err)
            else:
                want = want.float()
                err = float((got.float() - want).abs().max() / want.abs().max())
                assert err <= 8e-3, (BH, L, dqk, dv, err)
