"""The general form of the Barron robust loss (PyTorch).

rho(x, alpha, c) from "A General and Adaptive Robust Loss Function"
(Barron, arXiv:1701.03077).  The function itself lives beside its Hopper
kernel as that kernel's plain version, ``ops/robust_loss.
robust_lossfun_plain``; this module gives it the name the JAX package's
``losses/robust/general.py`` gives it.
"""

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops.robust_loss import (  # noqa: F401
    robust_lossfun_plain as lossfun,
)
