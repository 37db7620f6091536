"""The full ViT-H SAM architecture oracle for the PyTorch port, the
counterpart of ``examples/oracle_sam_vith.py``: the port's ViT-H encoder
(embed 1280, depth 32, 16 heads, window 14, global blocks 7/15/23/31, a
1024x1024 input) and its full-size prompt encoder and mask decoder against
transformers' ``SamModel`` on shared random weights (seed 17, eager
attention), through ``nets/hf_oracle``'s name mapping.  Bound: the JAX
script's 1e-4 max relative error on the embedding, the low-res masks of 8
prompts and their IoU scores.  CPU, float32; two ViT-H forwards, about a
minute and some 10 GB of host memory, so the file is ``slow``.
transformers is a test dependency only (the card's host has none)."""

import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow

transformers = pytest.importorskip("transformers")

from super_primitive_tpu_torch.nets import hf_oracle  # noqa: E402
from super_primitive_tpu_torch.nets.sam.image_encoder import (  # noqa: E402
    VIT_H,
    config_from_state_dict,
)
from super_primitive_tpu_torch.nets.sam.predictor import build_sam, decode_prompts  # noqa: E402

TOL = 1e-4
PROMPTS = 8


def max_rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def test_vit_h_matches_transformers():
    from transformers import SamConfig, SamModel
    from transformers.models.sam.configuration_sam import SamVisionConfig

    t0 = time.perf_counter()
    model = SamModel(SamConfig(
        vision_config=SamVisionConfig(hidden_size=1280, num_hidden_layers=32,
                                      num_attention_heads=16,
                                      global_attn_indexes=[7, 15, 23, 31]),
        attn_implementation="eager"))
    hf_oracle.randomize_torch_state(model, seed=17)
    sd = hf_oracle.hf_sam_to_original(model.state_dict())
    assert config_from_state_dict(sd) == VIT_H
    sam = build_sam(sd, VIT_H, "cpu")
    del sd

    rng = np.random.default_rng(0)
    img = rng.normal(0, 1, (1, 1024, 1024, 3)).astype(np.float32)
    with torch.no_grad():
        emb_t = model.vision_encoder(
            torch.from_numpy(img.transpose(0, 3, 1, 2).copy())).last_hidden_state.numpy()
        emb = sam.image_encoder(torch.from_numpy(img)).numpy()
    d_enc = max_rel(np.moveaxis(emb, -1, 1), emb_t)

    # the prompt encoder and mask decoder at full size, on the torch embedding
    pts = rng.uniform(0, 1023, (PROMPTS, 2)).astype(np.float32)
    with torch.no_grad():
        out = model(image_embeddings=torch.from_numpy(emb_t),
                    input_points=torch.from_numpy(pts.reshape(1, PROMPTS, 1, 2)),
                    input_labels=torch.ones((1, PROMPTS, 1), dtype=torch.long),
                    multimask_output=True)
        masks, iou = decode_prompts(
            sam.prompt_encoder, sam.mask_decoder,
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(emb_t, 1, -1))),
            sam.prompt_encoder.get_dense_pe(), torch.from_numpy(pts))
    d_masks = max_rel(masks[:, 1:].numpy(), out.pred_masks[0].numpy())
    d_iou = max_rel(iou[:, 1:].numpy(), out.iou_scores[0].numpy())
    print(f"ViT-H oracle: encoder {d_enc:.3e}, low-res masks {d_masks:.3e}, IoU {d_iou:.3e} "
          f"max relative error; {time.perf_counter() - t0:.1f} s")
    assert d_enc < TOL and d_masks < TOL and d_iou < TOL
