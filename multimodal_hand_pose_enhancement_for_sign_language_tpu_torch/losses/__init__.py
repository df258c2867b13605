"""Loss registry mirroring the reference LOSSES (utils/constants.py:55-58)."""

from __future__ import annotations

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses import robust  # noqa: F401
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses.basic import (  # noqa: F401
    huber_loss,
    l1_loss,
    l2_loss,
    mse_loss,
)


def get_loss(name: str):
    """Resolve a loss name to a mean-reduced callable loss(pred, target).

    "RobustLoss" is special-cased by the trainer (it needs num_dims and
    the latents); this registry returns the element losses.
    """
    table = {
        "L1": l1_loss,
        "L2": l2_loss,
        "Huber1": lambda p, t: huber_loss(p, t, delta=1.0),
    }
    if name not in table:
        raise KeyError(f"unknown loss {name!r}; use L1/L2/Huber1 or RobustLoss")
    return table[name]
