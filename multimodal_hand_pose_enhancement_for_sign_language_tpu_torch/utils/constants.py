"""Static registries and joint-index constants.

Mirrors the contract of the reference's ``utils/constants.py``
(the reference's utils/constants.py:5-58): pipeline feature map, OpenPose
joint-index groups, r6d pickle names, model registry.  Re-designed here as
pure data (no torch imports, no global device state).
"""

# Per-frame r6d layout: one 6-float block per bone, ARM block first
# (6 bones x 6 = 36 floats), then HANDS (42 bones x 6 = 252 floats).
# See reference utils/constants.py:11-27.
R6D_PER_BONE = 6
N_ARM_BONES = 6
N_HAND_BONES = 42

FEATURE_MAP = {
    "arm2wh": (6 * 6, 42 * 6),
    # predict hands, including wrists, given arms and hands
    "arm_wh2wh": ((6 + 42) * 6, 42 * 6),
    # predict the K last finger groups of the left hand (then right hand)
    # given arms and the remaining fingers
    "arm_wh2finger1": ((6 + 38) * 6, 4 * 6),
    "arm_wh2finger2": ((6 + 34) * 6, 8 * 6),
    "arm_wh2finger3": ((6 + 30) * 6, 12 * 6),
    "arm_wh2finger4": ((6 + 26) * 6, 16 * 6),
    "arm_wh2finger5": ((6 + 22) * 6, 20 * 6),
    "arm_wh2finger6": ((6 + 21) * 6, 21 * 6),
    "arm_wh2finger7": ((6 + 17) * 6, 25 * 6),
    "arm_wh2finger8": ((6 + 13) * 6, 29 * 6),
    "arm_wh2finger9": ((6 + 9) * 6, 33 * 6),
    "arm_wh2finger10": ((6 + 5) * 6, 37 * 6),
    "arm_wh2finger11": ((6 + 1) * 6, 41 * 6),
    "arm_wh2finger12": ((6 + 0) * 6, 42 * 6),
    "wh2wh": (42 * 6, 42 * 6),  # hand to hand
}

# OpenPose BODY_25 joint groups (reference utils/constants.py:29-32).
NECK = [0, 1]
WRIST = [[4, 7], [0, 21]]  # wrist indices in arms, wrist indices in hands
ARMS = [2, 3, 4, 5, 6, 7]
HANDS = list(range(21 * 2))

EPSILON = 1e-10

# Relative (data_dir-anchored) OpenPose json locations per split
# (reference utils/constants.py:5-9).
DATA_PATHS = {
    "train": "train/rgb_front/features/openpose_output/json",
    "val": "val/rgb_front/features/openpose_output/json",
    "test": "test/rgb_front/features/openpose_output/json",
}

DATA_PATHS_r6d = {
    "train": "r6d_train.pkl",
    "val": "r6d_val.pkl",
    "test": "r6d_test.pkl",
}

# Model registry: short name -> generator class name in models.generators
# (reference utils/constants.py:45-51).
MODELS = {
    "v1": "regressor_fcn_bn_32",
    "b2h": "regressor_fcn_bn_32_b2h",
    "v2": "regressor_fcn_bn_32_v2",
    "v4": "regressor_fcn_bn_32_v4",
    "v4_deeper": "regressor_fcn_bn_32_v4_deeper",
}

# Loss registry (reference utils/constants.py:55-58); resolved lazily in
# losses/__init__.py to callables.
LOSSES = ("L1", "L2", "Huber1", "RobustLoss")

# Fixed window length every consumer pads/cuts to
# (reference utils/postprocess_utils.py:33, load_save_utils.py:44).
WINDOW_T = 192
