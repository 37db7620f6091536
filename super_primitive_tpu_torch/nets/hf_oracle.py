"""Architecture oracles: name mappings from transformers' torch SAM and
EfficientNet to the published checkpoint names.

Port of ``super_primitive_tpu/nets/hf_oracle.py``.  The published
checkpoints (``sam_vit_h_4b8939.pth``, ``scannet.pth``) are not in the
repository, so the port's nets are held against independent
implementations of the same architectures on shared random weights:
transformers' ``SamModel`` (ported from facebook/segment-anything) and
``EfficientNetModel`` (ported from the TF original that geffnet's
``tf_efficientnet_b5`` mirrors).  The port's modules carry the published
names, so a mapped state dict loads straight into them (``Sam``,
``frontend_from_state_dicts``): any convention mismatch (conv layout, TF
SAME padding, rel-pos, window padding, norm eps, prompt labels, decoder
taps) shows as a numeric difference.

transformers' EfficientNet pads TF SAME with Keras's fixed pads, which
equal the dynamic pads when every stride-2 conv sees an even input: true
at the NNET's 480x640 and at the test sizes.

This module imports neither transformers nor the JAX package; the test
(``tests/test_torch_hf_oracle.py``) builds the transformers models.
"""

from __future__ import annotations

import re

import numpy as np

# (pattern, replacement); replacement None = key intentionally dropped
_SAM_RULES: list[tuple[str, str | None]] = [
    (r"^vision_encoder\.patch_embed\.projection\.", "image_encoder.patch_embed.proj."),
    (r"^vision_encoder\.pos_embed$", "image_encoder.pos_embed"),
    (r"^vision_encoder\.layers\.(\d+)\.layer_norm1\.", r"image_encoder.blocks.\1.norm1."),
    (r"^vision_encoder\.layers\.(\d+)\.layer_norm2\.", r"image_encoder.blocks.\1.norm2."),
    (r"^vision_encoder\.layers\.(\d+)\.attn\.", r"image_encoder.blocks.\1.attn."),
    (r"^vision_encoder\.layers\.(\d+)\.mlp\.", r"image_encoder.blocks.\1.mlp."),
    (r"^vision_encoder\.neck\.conv1\.", "image_encoder.neck.0."),
    (r"^vision_encoder\.neck\.layer_norm1\.", "image_encoder.neck.1."),
    (r"^vision_encoder\.neck\.conv2\.", "image_encoder.neck.2."),
    (r"^vision_encoder\.neck\.layer_norm2\.", "image_encoder.neck.3."),
    (
        r"^shared_image_embedding\.positional_embedding$",
        "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
    ),
    # tied duplicate of shared_image_embedding (SamModel._tie_weights)
    (r"^prompt_encoder\.shared_embedding\.positional_embedding$", None),
    (
        r"^prompt_encoder\.point_embed\.(\d+)\.weight$",
        r"prompt_encoder.point_embeddings.\1.weight",
    ),
    (r"^prompt_encoder\.not_a_point_embed\.", "prompt_encoder.not_a_point_embed."),
    (r"^prompt_encoder\.no_mask_embed\.", "prompt_encoder.no_mask_embed."),
    # mask-input prompts are unused by the pipeline (and by the converter)
    (r"^prompt_encoder\.mask_embed\.", None),
    (r"^mask_decoder\.iou_token\.", "mask_decoder.iou_token."),
    (r"^mask_decoder\.mask_tokens\.", "mask_decoder.mask_tokens."),
    (
        r"^mask_decoder\.transformer\.layers\.(\d+)\.layer_norm(\d)\.",
        r"mask_decoder.transformer.layers.\1.norm\2.",
    ),
    (r"^mask_decoder\.transformer\.layers\.(\d+)\.", r"mask_decoder.transformer.layers.\1."),
    (
        r"^mask_decoder\.transformer\.layer_norm_final_attn\.",
        "mask_decoder.transformer.norm_final_attn.",
    ),
    (
        r"^mask_decoder\.transformer\.final_attn_token_to_image\.",
        "mask_decoder.transformer.final_attn_token_to_image.",
    ),
    (r"^mask_decoder\.upscale_conv1\.", "mask_decoder.output_upscaling.0."),
    (r"^mask_decoder\.upscale_layer_norm\.", "mask_decoder.output_upscaling.1."),
    (r"^mask_decoder\.upscale_conv2\.", "mask_decoder.output_upscaling.3."),
    # SamFeedForward(num_layers=3) = proj_in, layers.0, proj_out
    #   <-> original MLP layers.{0,1,2}
    (
        r"^mask_decoder\.output_hypernetworks_mlps\.(\d+)\.proj_in\.",
        r"mask_decoder.output_hypernetworks_mlps.\1.layers.0.",
    ),
    (
        r"^mask_decoder\.output_hypernetworks_mlps\.(\d+)\.layers\.0\.",
        r"mask_decoder.output_hypernetworks_mlps.\1.layers.1.",
    ),
    (
        r"^mask_decoder\.output_hypernetworks_mlps\.(\d+)\.proj_out\.",
        r"mask_decoder.output_hypernetworks_mlps.\1.layers.2.",
    ),
    (r"^mask_decoder\.iou_prediction_head\.proj_in\.",
     "mask_decoder.iou_prediction_head.layers.0."),
    (r"^mask_decoder\.iou_prediction_head\.layers\.0\.",
     "mask_decoder.iou_prediction_head.layers.1."),
    (r"^mask_decoder\.iou_prediction_head\.proj_out\.",
     "mask_decoder.iou_prediction_head.layers.2."),
]


def hf_sam_to_original(sd: dict) -> dict:
    """Map a transformers ``SamModel`` state_dict (name -> tensor/array) to
    the original segment-anything checkpoint naming, which the port's
    ``nets.sam.predictor.Sam`` carries (numpy values).

    Raises on any unrecognized key so a transformers layout change fails
    loudly instead of silently dropping weights.
    """
    out: dict = {}
    for k, v in sd.items():
        v = np.asarray(v)
        for pat, repl in _SAM_RULES:
            m = re.match(pat, k)
            if m:
                if repl is not None:
                    out[re.sub(pat, repl, k)] = v
                break
        else:
            raise KeyError(f"unmapped transformers SAM key: {k}")
    return out


# EfficientNet: HF flat block index -> geffnet blocks.{stage}.{rep}
def _b5_flat_to_stage(num_block_repeats, depth_coefficient):
    pairs = []
    for si, r in enumerate(num_block_repeats):
        for bi in range(int(np.ceil(depth_coefficient * r))):
            pairs.append((si, bi))
    return pairs


def hf_efficientnet_to_geffnet(
    sd: dict,
    num_block_repeats=(1, 2, 2, 3, 3, 4, 1),
    depth_coefficient: float = 2.2,
) -> dict:
    """Map a transformers ``EfficientNetModel`` state_dict to geffnet
    ``tf_efficientnet_b5`` naming under the NNET checkpoint prefix
    ``encoder.original_model``, which the port's ``nets.nnet.NNET`` carries
    (numpy values).

    Only encoder keys are produced (the NNET decoder has no transformers
    counterpart; overlay these onto a full synthetic NNET state dict).
    """
    E = "encoder.original_model"
    out: dict = {}

    def bn(dst, src):
        for a, b in (
            ("weight", "weight"),
            ("bias", "bias"),
            ("running_mean", "running_mean"),
            ("running_var", "running_var"),
        ):
            out[f"{dst}.{a}"] = np.asarray(sd[f"{src}.{b}"])

    out[f"{E}.conv_stem.weight"] = np.asarray(sd["embeddings.convolution.weight"])
    bn(f"{E}.bn1", "embeddings.batchnorm")

    for fb, (si, bi) in enumerate(_b5_flat_to_stage(num_block_repeats, depth_coefficient)):
        p = f"encoder.blocks.{fb}"
        g = f"{E}.blocks.{si}.{bi}"
        for a in ("weight", "bias"):
            out[f"{g}.se.conv_reduce.{a}"] = np.asarray(sd[f"{p}.squeeze_excite.reduce.{a}"])
            out[f"{g}.se.conv_expand.{a}"] = np.asarray(sd[f"{p}.squeeze_excite.expand.{a}"])
        dw = np.asarray(sd[f"{p}.depthwise_conv.depthwise_conv.weight"])
        if si == 0:
            # DepthwiseSeparable: conv_dw/bn1, se, conv_pw/bn2
            out[f"{g}.conv_dw.weight"] = dw
            bn(f"{g}.bn1", f"{p}.depthwise_conv.depthwise_norm")
            out[f"{g}.conv_pw.weight"] = np.asarray(sd[f"{p}.projection.project_conv.weight"])
            bn(f"{g}.bn2", f"{p}.projection.project_bn")
        else:
            # InvertedResidual: conv_pw/bn1, conv_dw/bn2, se, conv_pwl/bn3
            out[f"{g}.conv_pw.weight"] = np.asarray(sd[f"{p}.expansion.expand_conv.weight"])
            bn(f"{g}.bn1", f"{p}.expansion.expand_bn")
            out[f"{g}.conv_dw.weight"] = dw
            bn(f"{g}.bn2", f"{p}.depthwise_conv.depthwise_norm")
            out[f"{g}.conv_pwl.weight"] = np.asarray(sd[f"{p}.projection.project_conv.weight"])
            bn(f"{g}.bn3", f"{p}.projection.project_bn")

    out[f"{E}.conv_head.weight"] = np.asarray(sd["encoder.top_conv.weight"])
    return out


def randomize_torch_state(model, seed: int = 0, std: float = 0.05):
    """Fill every parameter and buffer of a torch module, in place, with
    seeded, numerically sane random values: norm scales near 1, running
    variances positive, everything else N(0, std).  Distinct values per
    tensor make any mix-up of weights show as a numeric difference."""
    import torch

    rng = np.random.default_rng(seed)
    new = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            new[k] = v
            continue
        is_norm = any(t in k for t in ("norm", "batchnorm", ".bn", "_bn"))
        if k.endswith("running_var"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean"):
            arr = rng.normal(0.0, 0.1, shape)
        elif is_norm and k.endswith(".weight"):
            arr = 1.0 + rng.normal(0.0, 0.1, shape)
        elif "positional_embedding" in k or "gaussian" in k:
            arr = rng.normal(0.0, 1.0, shape)
        elif k.endswith(".bias"):
            arr = rng.normal(0.0, 0.02, shape)
        else:
            arr = rng.normal(0.0, std, shape)
        new[k] = torch.tensor(np.asarray(arr, np.float32))
    model.load_state_dict(new)
    if hasattr(model, "tie_weights"):
        model.tie_weights()
    model.eval()
    return model
