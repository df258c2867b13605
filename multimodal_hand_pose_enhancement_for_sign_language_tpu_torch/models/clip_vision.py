"""CLIP's vision tower (ViT-B/32 image encoder) and its preprocessing.

The port's counterpart of the JAX package's ``models/clip_vision.py`` (the
replacement of the reference's ``encode_image``, proc_vid.py:111-142), in
HF ``CLIPVisionModelWithProjection``'s keys (``vision_model.*`` and
``visual_projection.weight``, with HF's ``pre_layrnorm`` spelling): a
bias-free patch convolution of stride ``patch_size``, the class token,
learned positions, ``pre_layrnorm``, the shared ``CLIPLayer`` blocks,
``post_layernorm`` on the class token and a bias-free projection.  Images
are NCHW here (the crops already are); the JAX tower takes NHWC.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    hf_snapshot,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.text_encoders import (
    CLIPLayer,
    materialize,
)

# openai CLIP preprocessing constants (Normalize in clip.load's transform)
CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class CLIPVisionEmbeddings(nn.Module):
    """Patch embedding, class token and positions (HF ``CLIPVisionEmbeddings``)."""

    def __init__(self, hidden_size, image_size, patch_size):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(hidden_size))
        self.patch_embedding = nn.Conv2d(3, hidden_size, patch_size, stride=patch_size,
                                         bias=False)
        self.position_embedding = nn.Embedding((image_size // patch_size) ** 2 + 1,
                                               hidden_size)

    def forward(self, pixels):
        patches = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(pixels.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class CLIPVisionEncoder(nn.Module):
    """CLIP's image tower with its visual projection (``encode_image``)."""

    def __init__(self, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
                 image_size=224, patch_size=32, projection_dim=512, eps=1e-5):
        super().__init__()
        self.image_size = image_size
        self.vision_model = nn.ModuleDict({
            "embeddings": CLIPVisionEmbeddings(hidden_size, image_size, patch_size),
            "pre_layrnorm": nn.LayerNorm(hidden_size, eps=eps),
            "encoder": nn.ModuleDict({"layers": nn.ModuleList(
                [CLIPLayer(hidden_size, num_heads, intermediate_size, eps)
                 for _ in range(num_layers)])}),
            "post_layernorm": nn.LayerNorm(hidden_size, eps=eps),
        })
        self.visual_projection = nn.Linear(hidden_size, projection_dim, bias=False)

    def forward(self, pixels, return_hidden: bool = False):
        """pixels: (B, 3, H, W), already resized and CLIP-normalized."""
        vm = self.vision_model
        h = vm["pre_layrnorm"](vm["embeddings"](pixels))
        for layer in vm["encoder"]["layers"]:
            h = layer(h, None)
        out = self.visual_projection(vm["post_layernorm"](h[:, 0]))
        return (out, h) if return_hidden else out


def clip_vision_state(state_dict) -> dict:
    """The vision tower's keys of a ``CLIPVisionModelWithProjection`` or a
    full ``CLIPModel`` dump, without the position-id buffer."""
    return {k: v for k, v in state_dict.items()
            if (k.startswith("vision_model.") or k == "visual_projection.weight")
            and k != "vision_model.embeddings.position_ids"}


def load_clip_vision(model_dir: str, device="cuda") -> CLIPVisionEncoder:
    """A CLIP snapshot's vision tower on ``device``, loaded strictly: widths
    from the weights, depth, heads and image geometry from config.json
    (``vision_config`` of a full CLIPModel)."""
    cfg = hf_snapshot.read_config(model_dir)
    vcfg = cfg.get("vision_config", cfg)
    sd = clip_vision_state(hf_snapshot.read_state(model_dir))
    proj, hidden = sd["visual_projection.weight"].shape
    kw = dict(
        hidden_size=int(hidden),
        num_layers=int(vcfg["num_hidden_layers"]),
        num_heads=int(vcfg["num_attention_heads"]),
        intermediate_size=int(sd["vision_model.encoder.layers.0.mlp.fc1.weight"].shape[0]),
        image_size=int(vcfg["image_size"]),
        patch_size=int(vcfg["patch_size"]),
        projection_dim=int(proj),
    )
    return materialize(lambda: CLIPVisionEncoder(**kw), device, state_dict=sd)


def cubic_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of a bicubic resize along one axis, as
    ``jax.image.resize(..., "bicubic")`` builds them (``compute_weight_mat``):
    Keys' cubic with a = -0.5 at half-pixel sample points, widened by the
    scale when shrinking, each output's weights normalized to sum to 1."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(inv_scale)
              - np.float32(0.5))
    x = (np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
         / np.float32(max(inv_scale, 1.0)))
    w = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    w = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
                 + np.float32(2.0), w)
    w = np.where(x >= 2.0, np.float32(0.0), w)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def clip_preprocess(frames, image_size=224):
    """(T, 3, H, W) 0-255 frames (a tensor, on the device that runs the
    tower) -> (T, 3, image_size, image_size) CLIP input: /255, bicubic
    resize, CLIP normalization.

    The resize is ``jax.image.resize(..., "bicubic")``'s (the JAX
    package's): two products with ``cubic_resize_weights``.  PyTorch's
    ``interpolate(mode="bicubic")`` is another cubic (a = -0.75, clamped
    edges); with ``antialias`` it is Keys' a = -0.5 but computed otherwise."""
    x = frames.to(torch.float32) / 255.0
    H, W = x.shape[-2:]
    wh, ww = (torch.from_numpy(cubic_resize_weights(n, image_size)).to(x.device)
              for n in (H, W))
    x = torch.matmul(wh.T, torch.matmul(x, ww))
    mean = torch.as_tensor(CLIP_IMAGE_MEAN, device=x.device)[:, None, None]
    std = torch.as_tensor(CLIP_IMAGE_STD, device=x.device)[:, None, None]
    return (x - mean) / std
