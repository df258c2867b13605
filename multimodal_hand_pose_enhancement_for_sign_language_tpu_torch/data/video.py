"""Video featurizer: hand crops and their CNN features.

The port's counterpart of the JAX package's ``data/video.py`` (the
re-design of the reference's proc_vid.py, paths as arguments).  Video
decoding needs cv2 and is imported where it runs; the crop geometry is
numpy; the features run through the port's towers on ``device``, TF32 off:
ResNet-50 (``models/resnet``, torchvision's keys) and CLIP's vision tower
(``models/clip_vision``, from a local Hugging Face snapshot).  Crops are
(T, C, 120, 120, 2) uint8, right hand then left, already NCHW per hand.
This module imports no torch until a feature runs.

The reference's crop_clip returns inside its frame loop (proc_vid.py:94),
so only frame 0 is cropped; ``faithful_first_frame_bug=True`` reproduces
that for artifacts made by the reference, the default crops every frame.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

CROP_HW = (120, 120)
HAND_KEYPOINT_IDS = [5, 9, 13, 17]  # MP joints used for the palm center
FALLBACK_CENTER = (700, 700)  # proc_vid.py:320-321
# ImageNet normalization on the 0-255 scale (proc_vid.py:183-186)
IMAGENET_MEAN = np.array([123.68, 116.779, 103.939], np.float32)
IMAGENET_STD = np.array([58.393, 57.12, 57.375], np.float32)
CLIP_BATCH = 256  # crops a CLIP vision forward


def load_clip(path: str) -> np.ndarray:
    """mp4 -> (T, C, H, W) uint8 RGB (proc_vid.py:31-43); needs cv2."""
    import cv2

    frames = []
    cap = cv2.VideoCapture(path)
    ret = True
    while ret:
        ret, img = cap.read()
        if ret:
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    video = np.stack(frames, axis=0)
    return np.moveaxis(video, 3, 1)


def get_vid_ids(vid_dir: str) -> list:
    """Ids of clips with an .mp4 present (proc_vid.py:66-68)."""
    return [x[:-4] for x in os.listdir(vid_dir) if x.endswith(".mp4")]


def get_hand_center(keypoints_json: Optional[dict], hand: str = "right"):
    """Mean of the palm keypoints, fallback (700, 700) if json missing
    (proc_vid.py:312-336)."""
    if keypoints_json is None:
        return FALLBACK_CENTER
    kp = keypoints_json["people"][0][f"hand_{hand}_keypoints_2d"]
    xs = [kp[i * 3] for i in HAND_KEYPOINT_IDS]
    ys = [kp[i * 3 + 1] for i in HAND_KEYPOINT_IDS]
    return (float(np.mean(xs)), float(np.mean(ys)))


def crop_frame(frame_hwc: np.ndarray, center, size=CROP_HW) -> np.ndarray:
    """Pad-and-crop a (H, W, C) frame around ``center`` (proc_vid.py:281-309);
    the part outside the frame is zero."""
    h, w = size
    top = int(np.floor(center[1])) - h // 2
    left = int(np.floor(center[0])) - w // 2
    H, W, C = frame_hwc.shape
    out = np.zeros((h, w, C), frame_hwc.dtype)
    src_t, src_l = max(top, 0), max(left, 0)
    src_b, src_r = min(top + h, H), min(left + w, W)
    if src_b > src_t and src_r > src_l:
        dst_t, dst_l = src_t - top, src_l - left
        out[dst_t: dst_t + (src_b - src_t), dst_l: dst_l + (src_r - src_l)] = (
            frame_hwc[src_t:src_b, src_l:src_r]
        )
    return out


def crop_clip(clip: np.ndarray, clip_id: str, input_json_folder: str,
              faithful_first_frame_bug: bool = False) -> np.ndarray:
    """(T, C, H, W) -> (T, C, 120, 120, 2) right/left hand crops around the
    palm centers of ``{clip_id}_{frame:012d}_keypoints.json``; a frame
    without a readable JSON is cropped at the fallback center
    (proc_vid.py:70-94)."""
    T = clip.shape[0]
    out = np.zeros((T, clip.shape[1], *CROP_HW, 2), np.uint8)
    hands = ("right", "left")
    for i in range(1 if faithful_first_frame_bug else T):
        path = os.path.join(input_json_folder, f"{clip_id}_{i:012d}_keypoints.json")
        try:
            with open(path) as f:
                keypoints_json = json.load(f)
        except (OSError, ValueError):
            keypoints_json = None
        frame = np.moveaxis(clip[i], 0, -1)
        for j, hand in enumerate(hands):
            center = get_hand_center(keypoints_json, hand=hand)
            out[i, :, :, :, j] = np.moveaxis(crop_frame(frame, center), -1, 0)
    return out


def obtain_cropped_clips(clip_list, json_root: str, s_ids, **kwargs) -> list:
    """Crop every clip (replaces Pool(24), proc_vid.py:244-254)."""
    return [
        crop_clip(c, sid, os.path.join(json_root, sid), **kwargs)
        for c, sid in zip(clip_list, s_ids)
    ]


# ---------------------------------------------------------------------------
# CNN features
# ---------------------------------------------------------------------------


def _hands(crops_list, model, batch_size, device, prepare) -> list:
    """(T, 2 * width) float32 per clip: ``model(prepare(batch))`` over the
    right hand's frames, then the left's, side by side.  Each clip goes to
    ``device`` once as uint8; batches are sliced there, TF32 off."""
    import torch

    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.infer import (
        conv_matmul_precision,
    )

    feats = []
    with torch.inference_mode(), conv_matmul_precision("float32"):
        for crop in crops_list:
            x = torch.from_numpy(np.ascontiguousarray(crop)).to(device)
            hands = [torch.cat([model(prepare(x[s: s + batch_size, ..., j]))
                                for s in range(0, x.shape[0], batch_size)]).cpu().numpy()
                     for j in (0, 1)]
            feats.append(np.hstack(hands).astype(np.float32))
    return feats


def obtain_feats_crops_resnet(crops_list, weights_path: Optional[str] = None,
                              batch_size: int = 256, device="cuda") -> list:
    """(T, C, 120, 120, 2) crops -> (T, 2000) float32 features, 1000 per hand
    (proc_vid.py:145-203), through the port's ResNet-50 on ``device``.

    ``weights_path``: a torchvision resnet50 ``.pth``; without one the tower
    is randomly initialised (``models/resnet.load_resnet50``: the features
    are then meaningless, but the pipeline runs)."""
    import torch

    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import resnet
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device(device)
    model = resnet.load_resnet50(weights_path, device=dev)
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=dev)[:, None, None]

    return _hands(crops_list, model, batch_size, dev,
                  lambda x: (x.to(torch.float32) - mean) / std)


def obtain_feats_crops_clip(crops_list, weights_path: Optional[str] = None,
                            device="cuda") -> list:
    """CLIP ViT-B/32 image features per hand, (T, 2 * projection) float32
    (proc_vid.py:111-142).

    With ``weights_path`` (a local HF CLIP snapshot) the features run
    through the port's ``CLIPVisionEncoder`` on ``device``; without it,
    through the ``clip`` package (downloads), as in the JAX package."""
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device(device)
    if weights_path is None:
        return _hub_clip_feats(crops_list, dev)
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
        clip_vision,
    )

    model = clip_vision.load_clip_vision(weights_path, device=dev)
    return _hands(crops_list, model, CLIP_BATCH, dev,
                  lambda x: clip_vision.clip_preprocess(x, model.image_size))


def _hub_clip_feats(crops_list, dev) -> list:
    """The JAX package's hub route: openai's ``clip`` package, PIL's
    preprocessing."""
    import clip
    import torch
    from PIL import Image

    model, preprocess = clip.load("ViT-B/32", dev)

    def embed(frames_tchw):
        imgs = [
            preprocess(Image.fromarray(np.moveaxis(f, 0, -1).astype(np.uint8), "RGB"))
            for f in frames_tchw
        ]
        with torch.no_grad():
            return model.encode_image(torch.stack(imgs).to(dev)).cpu().numpy()

    return [np.hstack((embed(c[..., 0]), embed(c[..., 1]))) for c in crops_list]


# ---------------------------------------------------------------------------
# debug / inspection utilities (reference proc_vid.py:255-377)
# ---------------------------------------------------------------------------


def save_as_mp4(vid, fps: int = 25, filename: str = "testing.avi"):
    """(T, C, H, W) RGB -> video file (proc_vid.py:256-262); needs cv2."""
    import cv2

    T, _, H, W = vid.shape
    writer = cv2.VideoWriter(filename, cv2.VideoWriter_fourcc(*"PIM1"), fps, (W, H), True)
    for i in range(T):
        x = np.moveaxis(vid[i], 0, -1)
        writer.write(np.uint8(x[..., ::-1]))
    writer.release()
    return filename


def overlap_vid_points(vid, points):
    """Paint (row, col) keypoints as red squares on a (T, H, W, C) video
    (proc_vid.py:267-276)."""
    out = vid.copy()
    for t in range(vid.shape[0]):
        p = points[t, :]
        for i in range(0, len(p), 2):
            r, c = int(p[i]), int(p[i + 1])
            out[t, r - 3: r + 3, c - 3: c + 3, 0] = 255
            out[t, r - 3: r + 3, c - 3: c + 3, 1:] = 0
    return out
