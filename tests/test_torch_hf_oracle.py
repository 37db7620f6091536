"""Architecture oracles for the PyTorch port: its SAM and EfficientNet-B5
against transformers' independent torch ports, on shared random weights.

The sizes and bounds are ``tests/test_hf_oracle.py``'s: a scaled-down SAM
that keeps every structural feature of ViT-H (windowed blocks with edge
padding, grid 6x6 and window 4, interleaved global blocks, decomposed
rel-pos, the LayerNorm neck, the two-way decoder and its heads), and the
full B5 (39 blocks, width 1.6, depth 2.2) at 64x96, where transformers'
fixed TF SAME pads equal the dynamic ones; relative error below 2e-5.  The
weights go transformers -> ``nets/hf_oracle`` (the port's copy of the
name mapping, held equal to the JAX package's) -> the port's modules, which
carry the published names.  CPU, float32.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from super_primitive_tpu.nets import hf_oracle as j_oracle  # noqa: E402
from super_primitive_tpu_torch.convert import nnet_state_dict  # noqa: E402
from super_primitive_tpu_torch.nets import hf_oracle as t_oracle  # noqa: E402
from super_primitive_tpu_torch.nets.nnet import NNET  # noqa: E402
from super_primitive_tpu_torch.nets.sam.image_encoder import (  # noqa: E402
    ViTConfig,
    config_from_state_dict,
)
from super_primitive_tpu_torch.nets.sam.predictor import build_sam, decode_prompts  # noqa: E402
from super_primitive_tpu_torch.nets.synth import synth_nnet_state_dict  # noqa: E402

IMG, EMBED, HEADS, DEPTH, GLOBALS, WINDOW, OUT_CH = 96, 64, 2, 4, (1, 3), 4, 32
TOL = 2e-5


def max_rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def assert_same_mapping(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def sam_pair():
    from transformers import SamConfig, SamModel
    from transformers.models.sam.configuration_sam import (
        SamMaskDecoderConfig,
        SamPromptEncoderConfig,
        SamVisionConfig,
    )

    cfg = SamConfig(
        vision_config=SamVisionConfig(
            hidden_size=EMBED, output_channels=OUT_CH, num_hidden_layers=DEPTH,
            num_attention_heads=HEADS, image_size=IMG, patch_size=16, window_size=WINDOW,
            global_attn_indexes=list(GLOBALS), num_pos_feats=OUT_CH // 2),
        prompt_encoder_config=SamPromptEncoderConfig(
            hidden_size=OUT_CH, image_size=IMG, patch_size=16, mask_input_channels=8),
        mask_decoder_config=SamMaskDecoderConfig(
            hidden_size=OUT_CH, mlp_dim=8 * OUT_CH, iou_head_hidden_dim=256),
        attn_implementation="eager",
    )
    model = SamModel(cfg)
    t_oracle.randomize_torch_state(model, seed=7)
    sd = t_oracle.hf_sam_to_original(model.state_dict())
    cfg_t = config_from_state_dict(sd)
    sam = build_sam(sd, cfg_t, "cpu")
    return model, sd, cfg_t, sam


def test_sam_mapping_equals_jax(sam_pair):
    model, sd, cfg, _ = sam_pair
    assert_same_mapping(sd, j_oracle.hf_sam_to_original(model.state_dict()))
    assert cfg == ViTConfig(img_size=IMG, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS,
                            window_size=WINDOW, global_attn_indexes=GLOBALS, out_chans=OUT_CH)
    with pytest.raises(KeyError, match="unmapped"):
        t_oracle.hf_sam_to_original({"vision_encoder.unknown": np.zeros(1)})


def test_vision_encoder_matches(sam_pair):
    model, _, _, sam = sam_pair
    img = np.random.default_rng(0).normal(0, 1, (1, IMG, IMG, 3)).astype(np.float32)
    with torch.no_grad():
        want = model.vision_encoder(
            torch.tensor(img.transpose(0, 3, 1, 2))).last_hidden_state.numpy()
        got = sam.image_encoder(torch.from_numpy(img)).numpy()
    assert max_rel(np.moveaxis(got, -1, 1), want) < TOL


def test_prompt_encoder_and_mask_decoder_match(sam_pair):
    model, _, _, sam = sam_pair
    S = IMG // 16
    rng = np.random.default_rng(2)
    emb = rng.normal(0, 0.5, (1, S, S, OUT_CH)).astype(np.float32)
    P = 5
    pts = rng.uniform(0, IMG - 1, (P, 2)).astype(np.float32)
    with torch.no_grad():
        out = model(image_embeddings=torch.tensor(emb.transpose(0, 3, 1, 2)),
                    input_points=torch.tensor(pts.reshape(1, P, 1, 2)),
                    input_labels=torch.ones((1, P, 1), dtype=torch.long),
                    multimask_output=True)
        masks, iou = decode_prompts(sam.prompt_encoder, sam.mask_decoder, torch.from_numpy(emb),
                                    sam.prompt_encoder.get_dense_pe(), torch.from_numpy(pts))
    assert max_rel(masks[:, 1:].numpy(), out.pred_masks[0].numpy()) < TOL
    assert max_rel(iou[:, 1:].numpy(), out.iou_scores[0].numpy()) < TOL


def test_full_b5_matches():
    """Full B5 with shared random weights: the seven stage taps and the
    pre-bn2 ``conv_head`` output the NNET decoder reads."""
    from transformers.models.efficientnet import EfficientNetConfig, EfficientNetModel

    cfg = EfficientNetConfig(width_coefficient=1.6, depth_coefficient=2.2, hidden_dim=2048,
                             batch_norm_eps=1e-3, hidden_act="swish", depthwise_padding=[])
    model = EfficientNetModel(cfg)
    t_oracle.randomize_torch_state(model, seed=11)
    mapped = t_oracle.hf_efficientnet_to_geffnet(model.state_dict())
    assert_same_mapping(mapped, j_oracle.hf_efficientnet_to_geffnet(model.state_dict()))
    sd = synth_nnet_state_dict()
    sd.update(mapped)
    nnet = NNET()
    nnet.load_state_dict(nnet_state_dict(sd))
    nnet.eval()

    # even at every stride-2 conv input, as 480x640 is
    img = np.random.default_rng(3).normal(0, 1, (1, 3, 64, 96)).astype(np.float32)
    with torch.no_grad():
        h = model.embeddings(torch.from_numpy(img))
        reps = [int(np.ceil(2.2 * r)) for r in (1, 2, 2, 3, 3, 4, 1)]
        stage_ends = set(np.cumsum(reps) - 1)
        taps_t = []
        for i, blk in enumerate(model.encoder.blocks):
            h = blk(h)
            if i in stage_ends:
                taps_t.append(h.numpy())
        head_t = model.encoder.top_conv(h).numpy()
        stages, head = nnet.encoder(torch.from_numpy(img))
    assert len(stages) == len(taps_t) == 7
    for i, (got, want) in enumerate(zip(stages, taps_t)):
        assert max_rel(got.numpy(), want) < TOL, i
    assert max_rel(head.numpy(), head_t) < TOL
