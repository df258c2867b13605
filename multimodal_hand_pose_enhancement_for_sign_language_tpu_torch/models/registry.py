"""Generator registry: short model name -> module, built with seeded weights.

Counterpart of the JAX package's ``models/registry.py``.  Only "v1"
(``regressor_fcn_bn_32``) is ported so far; the other names raise.
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
}


def resolve(model: str) -> str:
    """Short name or full class name -> full class name."""
    return MODELS.get(model, model)


def build_generator(model: str, feature_in_dim: int, feature_out_dim: int,
                    require_text: bool = False, default_size: int = 256,
                    dropout_rate: float = 0.5, seed: int = 0, device="cuda"):
    """Build a generator on ``device`` in eval mode, its weights drawn with
    PyTorch's default initialisation from ``torch.Generator`` seeded with
    ``seed`` (the global RNG is not touched).  Load a checkpoint over them
    with ``load_state_dict(..., strict=True)``."""
    name = resolve(model)
    if name not in _CLASSES:
        raise NotImplementedError(
            f"generator {model!r} is not ported yet; ported: {sorted(_CLASSES)}"
        )
    dev = resolve_device(device)
    with torch.device("meta"):
        net = _CLASSES[name](
            feature_in_dim, feature_out_dim, require_text=require_text,
            default_size=default_size, dropout_rate=dropout_rate,
        )
    net = net.to_empty(device=dev)
    init_torch_default_(net, torch.Generator().manual_seed(seed))
    return net.eval()
