"""Barron general & adaptive robust loss (PyTorch)."""

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses.robust.adaptive import (  # noqa: F401
    AdaptiveLossFunction,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses.robust.distribution import (  # noqa: F401
    Distribution,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses.robust.general import (  # noqa: F401
    lossfun,
)
