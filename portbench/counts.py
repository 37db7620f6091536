"""The yardstick's arithmetic: the published peaks of the card, the work a
kernel must do for a call, and the model FLOPs of a frame.

The kernel rows are frozen copies, at commit 51882e36a88e, of
``chip_smoke.py``'s ``bound_ms``, ``k3_bytes`` and K2's bytes and FLOPs
(``k2_row``).  The model FLOPs are counted here: two FLOPs a multiply-add
of every matrix product and convolution the published networks make, at
the frame's sizes; elementwise work, norms and softmax are not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: HBM bytes/s, float32 outside the
# tensor cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# K2: the masked stencil (16), three masked dots (9), the x, r and p
# updates (6) and the preconditioner (2) a pixel and CG iteration
K2_FLOPS_PER_PIXEL_ITER = 33


def bound_ms(nbytes: float, flops: float, flop_per_s: float = F32_FLOP_PER_S) -> float:
    """The least time (ms) the card could take: the larger of the bytes over
    HBM's rate and the FLOPs over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s) * 1e3


def k2_work(N: int, H: int, W: int, iters: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one K2 call over (N, H, W) fields whose segments
    ran ``iters`` CG iterations together: eight fields read and x written
    once; 33 FLOPs a pixel and iteration."""
    return 9 * N * H * W * 4, K2_FLOPS_PER_PIXEL_ITER * iters * H * W


def k3_bytes(N: int, S: int, s: int, input_hw) -> int:
    """The bytes an exact K3 must move: the region's low-res rows and the
    clamped neighbour row below them, read once, and three counts a slab."""
    R = min(-(-input_hw[0] // s) + 1, S)
    return (N * R * S + 3 * N) * 4


def _linear(tokens: int, cin: int, cout: int) -> int:
    return 2 * tokens * cin * cout


def _window_tokens(S: int, window: int) -> list[int]:
    """Real tokens in each window of the S x S grid padded to a multiple of
    ``window``."""
    sides = [min(window, S - lo) for lo in range(0, S, window)]
    return [a * b for a in sides for b in sides]


def sam_encoder_flops(sam: dict) -> int:
    """The ViT encoder on the S x S tokens of the image (padding tokens
    uncounted): patch embedding, every block's projections, MLP, scores,
    rel-pos terms and attention-weighted sum, and the neck."""
    D, P, C = sam["embed_dim"], sam["patch_size"], sam["out_chans"]
    S = sam["img_size"] // P
    L = S * S
    hidden = int(D * sam["mlp_ratio"])
    total = _linear(L, 3 * P * P, D)
    for i in range(sam["depth"]):
        total += _linear(L, D, 3 * D) + _linear(L, D, D) + 2 * _linear(L, D, hidden)
        if i in sam["global_attn_indexes"]:
            groups, side = [L], S
        else:
            groups, side = _window_tokens(S, sam["window_size"]), sam["window_size"]
        # q k^T and attn v over each group, and q against the 2 x side rel-pos rows
        total += sum(2 * 2 * n * n * D for n in groups) + 2 * L * 2 * side * D
    return total + _linear(L, D, C) + _linear(L, 9 * C, C)


def sam_decoder_flops(sam: dict, prompts: int) -> int:
    """Prompt encoding and mask decoding of ``prompts`` single-point prompts
    against one image's S x S embedding: the two-way transformer (2
    layers and the final token-to-image attention), the upscaling, the
    hypernetwork and IoU heads and the mask products."""
    C = sam["out_chans"]
    S = sam["img_size"] // sam["patch_size"]
    L, T = S * S, 1 + 4 + 2  # image tokens; IoU, 4 mask and 2 point tokens
    half = C // 2

    def attn(nq, nk, d):
        return (_linear(nq, C, d) + 2 * _linear(nk, C, d) + _linear(nq, d, C)
                + 2 * 2 * nq * nk * d)

    layer = (attn(T, T, C) + attn(T, L, half) + 2 * _linear(T, C, 8 * C)
             + attn(L, T, half))
    up = _linear(4 * L, C, C // 4) + _linear(16 * L, C // 4, C // 8)
    heads = 4 * (2 * _linear(1, C, C) + _linear(1, C, C // 8)) + \
        _linear(1, C, 256) + _linear(1, 256, 256) + _linear(1, 256, 4)
    per_prompt = 2 * 2 * 2 * half + 2 * layer + attn(T, L, half) + up + heads + \
        2 * 4 * (C // 8) * 16 * L
    return prompts * per_prompt


def nnet_flops(network_dim) -> int:
    """EfficientNet-B5 and the NNET decoder at ``network_dim``, from the
    frozen reference modules' shapes (every Conv2d and Conv1d; the
    align-corners resizes are interpolation and uncounted)."""
    import torch
    from torch import nn

    from .reference import nnet as ref

    total = [0]

    def conv_hook(m, args, out):
        if isinstance(m, nn.Conv2d):
            k = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
            total[0] += 2 * out.numel() * k

    with torch.device("meta"):
        model = ref.NNET()
    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, nn.Conv2d)]
    x = torch.empty(1, 3, *network_dim, device="meta")
    with torch.no_grad():
        stages, head = model.encoder(x)
    for h in hooks:
        h.remove()
    # the decoder's taps: stage 0, 1, 2 and 4 outputs (1/2 .. 1/16) and the head (1/32)
    t0, t1, t2, t4 = (tuple(stages[i].shape[2:]) for i in (0, 1, 2, 4))

    def conv(h, w, cin, cout, k):
        return 2 * h * w * cin * cout * k * k

    dec = conv(*head.shape[2:], 2048, 2048, 1)
    for (h, w), cin, cout in ((t4, 2048 + 176, 1024), (t2, 1024 + 64, 512),
                              (t1, 512 + 40, 256), (t0, 256 + 24, 128)):
        dec += conv(h, w, cin, cout, 3) + conv(h, w, cout, cout, 3)
    dec += conv(*t2, 512, 4, 3)
    # the refine heads' pointwise layers at 2x, 4x and 8x the 1/8 map
    for f, cin in ((2, 516), (4, 260), (8, 132)):
        dec += 2 * f * t2[0] * f * t2[1] * (cin * 128 + 128 * 128 * 2 + 128 * 4)
    return total[0] + dec


def frame_ideal_s(sam: dict, network_dim, prompts: int) -> float:
    """The least time a frame's model work could take on the card: the SAM
    encoder and decoder at the bf16 peak, the NNET at the float32 peak, the
    precisions the program computes them in."""
    return ((sam_encoder_flops(sam) + sam_decoder_flops(sam, prompts)) / BF16_FLOP_PER_S
            + nnet_flops(network_dim) / F32_FLOP_PER_S)
