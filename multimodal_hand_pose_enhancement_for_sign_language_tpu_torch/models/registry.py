"""Model registry: short model name -> module, built with seeded weights.

Counterpart of the JAX package's ``models/registry.py``: the five
generators by short name ("v1", "b2h", "v2", "v4", "v4_deeper") or class
name, and the reference's discriminator.
"""

from __future__ import annotations

import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    generators,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.layers import (
    init_torch_default_,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.constants import (
    MODELS,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)

_CLASSES = {
    "regressor_fcn_bn_32": generators.regressor_fcn_bn_32,
    "regressor_fcn_bn_32_b2h": generators.regressor_fcn_bn_32_b2h,
    "regressor_fcn_bn_32_v2": generators.regressor_fcn_bn_32_v2,
    "regressor_fcn_bn_32_v4": generators.regressor_fcn_bn_32_v4,
    "regressor_fcn_bn_32_v4_deeper": generators.regressor_fcn_bn_32_v4_deeper,
}


def resolve(model: str) -> str:
    """Short name or full class name -> full class name."""
    return MODELS.get(model, model)


def build_generator(model: str, feature_in_dim: int, feature_out_dim: int,
                    require_text: bool = False, require_image: bool = False,
                    default_size: int = 256, dropout_rate: float = 0.5,
                    seed: int = 0, device="cuda"):
    """Build a generator on ``device`` in eval mode, its weights drawn with
    PyTorch's default initialisation from ``torch.Generator`` seeded with
    ``seed`` (the global RNG is not touched).  Load a checkpoint over them
    with ``load_state_dict(..., strict=True)``.  b2h takes
    ``require_image``, the others ``require_text`` (JAX registry.py:54-68):
    the flag the model does not take is ignored, as there."""
    name = resolve(model)
    if name not in _CLASSES:
        raise KeyError(f"unknown generator {model!r}; known: {sorted(_CLASSES)}")
    cls = _CLASSES[name]
    if cls is generators.regressor_fcn_bn_32_b2h:
        cond = {"require_image": require_image}
    else:
        cond = {"require_text": require_text}
    return _materialize(
        lambda: cls(feature_in_dim, feature_out_dim, default_size=default_size,
                    dropout_rate=dropout_rate, **cond),
        seed, device)


def needs_feats(module) -> bool:
    """Does the generator take text or image features?"""
    return bool(getattr(module, "require_text", False)
                or getattr(module, "require_image", False))


def build_discriminator(feature_in_dim: int, dropout_rate: float = 0.5,
                        seed: int = 0, device="cuda"):
    """Build the motion discriminator on ``device`` in eval mode, seeded as
    ``build_generator`` seeds a generator."""
    return _materialize(
        lambda: generators.regressor_fcn_bn_discriminator(
            feature_in_dim, dropout_rate=dropout_rate),
        seed, device)


def _materialize(make, seed, device):
    dev = resolve_device(device)
    with torch.device("meta"):
        net = make()
    net = net.to_empty(device=dev)
    init_torch_default_(net, torch.Generator().manual_seed(seed))
    return net.eval()
