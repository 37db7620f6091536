"""Synthetic torch-style state dicts in the published checkpoint naming
schemes (segment-anything ``sam_vit_h_4b8939.pth``, scannet NNET
``scannet.pth``).

The port's own copy of ``super_primitive_tpu/nets/synth.py``: the same
generators, key order and values, so both packages see identical weights.
Shapes derive from the real channel plans; only the values are random.
"""

from __future__ import annotations

import numpy as np


def synth_sam_state_dict(cfg) -> dict:
    """State dict with the segment-anything naming scheme; shapes derived
    from ``cfg`` (an ImageEncoderViT config, e.g. VIT_TINY_TEST or the real
    ViT-H config)."""
    r = np.random.default_rng(0)
    sd = {}
    D, HN, P = cfg.embed_dim, cfg.num_heads, cfg.patch_size
    S = cfg.img_size // P
    C = cfg.out_chans
    hd = D // HN

    def w(name, *shape):
        sd[name] = r.normal(size=shape).astype(np.float32)

    w("image_encoder.patch_embed.proj.weight", D, 3, P, P)
    w("image_encoder.patch_embed.proj.bias", D)
    w("image_encoder.pos_embed", 1, S, S, D)
    for i in range(cfg.depth):
        p = f"image_encoder.blocks.{i}"
        for n in ("norm1", "norm2"):
            w(f"{p}.{n}.weight", D)
            w(f"{p}.{n}.bias", D)
        w(f"{p}.attn.qkv.weight", 3 * D, D)
        w(f"{p}.attn.qkv.bias", 3 * D)
        w(f"{p}.attn.proj.weight", D, D)
        w(f"{p}.attn.proj.bias", D)
        size = S if i in cfg.global_attn_indexes else cfg.window_size
        w(f"{p}.attn.rel_pos_h", 2 * size - 1, hd)
        w(f"{p}.attn.rel_pos_w", 2 * size - 1, hd)
        w(f"{p}.mlp.lin1.weight", int(D * 4), D)
        w(f"{p}.mlp.lin1.bias", int(D * 4))
        w(f"{p}.mlp.lin2.weight", D, int(D * 4))
        w(f"{p}.mlp.lin2.bias", D)
    w("image_encoder.neck.0.weight", C, D, 1, 1)
    w("image_encoder.neck.1.weight", C)
    w("image_encoder.neck.1.bias", C)
    w("image_encoder.neck.2.weight", C, C, 3, 3)
    w("image_encoder.neck.3.weight", C)
    w("image_encoder.neck.3.bias", C)

    w("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix", 2, C // 2)
    for i in range(4):
        w(f"prompt_encoder.point_embeddings.{i}.weight", 1, C)
    w("prompt_encoder.not_a_point_embed.weight", 1, C)
    w("prompt_encoder.no_mask_embed.weight", 1, C)

    def attn_ds(p, ds):
        d = C // ds
        w(f"{p}.q_proj.weight", d, C)
        w(f"{p}.q_proj.bias", d)
        w(f"{p}.k_proj.weight", d, C)
        w(f"{p}.k_proj.bias", d)
        w(f"{p}.v_proj.weight", d, C)
        w(f"{p}.v_proj.bias", d)
        w(f"{p}.out_proj.weight", C, d)
        w(f"{p}.out_proj.bias", C)

    for i in range(2):
        p = f"mask_decoder.transformer.layers.{i}"
        attn_ds(f"{p}.self_attn", 1)
        attn_ds(f"{p}.cross_attn_token_to_image", 2)
        attn_ds(f"{p}.cross_attn_image_to_token", 2)
        for n in ("norm1", "norm2", "norm3", "norm4"):
            w(f"{p}.{n}.weight", C)
            w(f"{p}.{n}.bias", C)
        w(f"{p}.mlp.lin1.weight", 8 * C, C)
        w(f"{p}.mlp.lin1.bias", 8 * C)
        w(f"{p}.mlp.lin2.weight", C, 8 * C)
        w(f"{p}.mlp.lin2.bias", C)
    attn_ds("mask_decoder.transformer.final_attn_token_to_image", 2)
    w("mask_decoder.transformer.norm_final_attn.weight", C)
    w("mask_decoder.transformer.norm_final_attn.bias", C)

    w("mask_decoder.iou_token.weight", 1, C)
    w("mask_decoder.mask_tokens.weight", 4, C)
    w("mask_decoder.output_upscaling.0.weight", C, C // 4, 2, 2)
    w("mask_decoder.output_upscaling.0.bias", C // 4)
    w("mask_decoder.output_upscaling.1.weight", C // 4)
    w("mask_decoder.output_upscaling.1.bias", C // 4)
    w("mask_decoder.output_upscaling.3.weight", C // 4, C // 8, 2, 2)
    w("mask_decoder.output_upscaling.3.bias", C // 8)
    for i in range(4):
        p = f"mask_decoder.output_hypernetworks_mlps.{i}"
        w(f"{p}.layers.0.weight", C, C)
        w(f"{p}.layers.0.bias", C)
        w(f"{p}.layers.1.weight", C, C)
        w(f"{p}.layers.1.bias", C)
        w(f"{p}.layers.2.weight", C // 8, C)
        w(f"{p}.layers.2.bias", C // 8)
    w("mask_decoder.iou_prediction_head.layers.0.weight", 256, C)
    w("mask_decoder.iou_prediction_head.layers.0.bias", 256)
    w("mask_decoder.iou_prediction_head.layers.1.weight", 256, 256)
    w("mask_decoder.iou_prediction_head.layers.1.bias", 256)
    w("mask_decoder.iou_prediction_head.layers.2.weight", 4, 256)
    w("mask_decoder.iou_prediction_head.layers.2.bias", 4)
    return sd


def scale_like_trained(sd: dict) -> dict:
    """A SAM state dict from :func:`synth_sam_state_dict` brought to the
    scale of a trained net, as the JAX package's torch oracle draws its
    weights (``nets/hf_oracle.randomize_torch_state``): norm weights
    1 + 0.1 w, the Fourier matrix as it is, everything else 0.05 w.  The
    std-1 weights drive attention scores into the thousands and saturate
    the softmax; at this scale two float32 summation orders agree to the
    oracle's bounds."""
    out = {}
    for k, v in sd.items():
        if "norm" in k or ".neck.1." in k or ".neck.3." in k or "output_upscaling.1." in k:
            v = (1.0 + 0.1 * v) if k.endswith("weight") else 0.05 * v
        elif "gaussian" not in k:
            v = 0.05 * v
        out[k] = np.asarray(v, np.float32)
    return out


def synth_nnet_state_dict() -> dict:
    """Synthetic scannet-style state dict for the B5 NNET (exact geffnet
    naming); shapes derived from the real channel plan."""
    r = np.random.default_rng(1)
    sd = {}

    def w(name, *shape):
        sd[name] = r.normal(size=shape).astype(np.float32) * 0.05

    def bn(name, ch):
        w(f"{name}.weight", ch)
        w(f"{name}.bias", ch)
        sd[f"{name}.running_mean"] = np.zeros(ch, np.float32)
        sd[f"{name}.running_var"] = np.ones(ch, np.float32)

    E = "encoder.original_model"
    w(f"{E}.conv_stem.weight", 48, 3, 3, 3)
    bn(f"{E}.bn1", 48)
    chans = [24, 40, 64, 128, 176, 304, 512]
    kernels = [3, 3, 5, 3, 5, 5, 3]
    expands = [1, 6, 6, 6, 6, 6, 6]
    reps = [3, 5, 5, 7, 7, 9, 3]
    in_ch = 48
    for si in range(7):
        for bi in range(reps[si]):
            b = f"{E}.blocks.{si}.{bi}"
            out_ch = chans[si]
            k = kernels[si]
            se_ch = max(1, int(in_ch * 0.25))
            if si == 0:
                w(f"{b}.conv_dw.weight", in_ch, 1, k, k)
                bn(f"{b}.bn1", in_ch)
                w(f"{b}.se.conv_reduce.weight", se_ch, in_ch, 1, 1)
                w(f"{b}.se.conv_reduce.bias", se_ch)
                w(f"{b}.se.conv_expand.weight", in_ch, se_ch, 1, 1)
                w(f"{b}.se.conv_expand.bias", in_ch)
                w(f"{b}.conv_pw.weight", out_ch, in_ch, 1, 1)
                bn(f"{b}.bn2", out_ch)
            else:
                mid = in_ch * expands[si]
                w(f"{b}.conv_pw.weight", mid, in_ch, 1, 1)
                bn(f"{b}.bn1", mid)
                w(f"{b}.conv_dw.weight", mid, 1, k, k)
                bn(f"{b}.bn2", mid)
                w(f"{b}.se.conv_reduce.weight", se_ch, mid, 1, 1)
                w(f"{b}.se.conv_reduce.bias", se_ch)
                w(f"{b}.se.conv_expand.weight", mid, se_ch, 1, 1)
                w(f"{b}.se.conv_expand.bias", mid)
                w(f"{b}.conv_pwl.weight", out_ch, mid, 1, 1)
                bn(f"{b}.bn3", out_ch)
            in_ch = out_ch
    w(f"{E}.conv_head.weight", 2048, 512, 1, 1)
    bn(f"{E}.bn2", 2048)

    D = "decoder"
    w(f"{D}.conv2.weight", 2048, 2048, 1, 1)
    w(f"{D}.conv2.bias", 2048)
    ups = [("up1", 2048 + 176, 1024), ("up2", 1024 + 64, 512),
           ("up3", 512 + 40, 256), ("up4", 256 + 24, 128)]
    for name, cin, cout in ups:
        w(f"{D}.{name}._net.0.weight", cout, cin, 3, 3)
        w(f"{D}.{name}._net.0.bias", cout)
        bn(f"{D}.{name}._net.1", cout)
        w(f"{D}.{name}._net.3.weight", cout, cout, 3, 3)
        w(f"{D}.{name}._net.3.bias", cout)
        bn(f"{D}.{name}._net.4", cout)
    w(f"{D}.out_conv_res8.weight", 4, 512, 3, 3)
    w(f"{D}.out_conv_res8.bias", 4)
    for head, cin in (("out_conv_res4", 516), ("out_conv_res2", 260),
                      ("out_conv_res1", 132)):
        dims = [(128, cin), (128, 128), (128, 128), (4, 128)]
        for j, (co, ci) in zip((0, 2, 4, 6), dims):
            w(f"{D}.{head}.{j}.weight", co, ci, 1)
            w(f"{D}.{head}.{j}.bias", co)
    return sd
