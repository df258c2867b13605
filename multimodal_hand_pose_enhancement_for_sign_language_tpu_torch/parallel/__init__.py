"""Multi-device layer over torch.distributed: mesh, global BatchNorm,
multi-host start-up, the time-sharded filter."""

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.parallel.mesh import (  # noqa: F401
    get_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)
