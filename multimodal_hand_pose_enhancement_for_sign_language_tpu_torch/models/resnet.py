"""ResNet-50 in torchvision's layout (NCHW) for the hand-crop features.

The port's counterpart of the JAX package's ``models/resnet.py`` (the
replacement of the reference's torchvision ResNet-50, proc_vid.py:178-203,
weights ``resnet50-0676ba61.pth``).  The keys are torchvision's (``conv1``,
``bn1``, ``layer{s}.{b}.conv{1,2,3}`` / ``bn{1,2,3}``,
``layer{s}.0.downsample.{0,1}``, ``fc``), so its ``.pth`` loads with
``strict=True``; stride on the 3x3 convolution (v1.5), BatchNorm eps 1e-5.
The towers run in eval mode (running statistics) on cuDNN, TF32 off under
``infer.conv_matmul_precision("float32")``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)

STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))  # width, blocks, stride
INIT_SEED = 0  # the JAX package draws its random init from PRNGKey(0)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, width, stride=1, downsample=False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, width * 4, 1, stride=stride, bias=False),
                nn.BatchNorm2d(width * 4))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """torchvision's ``resnet50``: (B, 3, H, W) -> (B, num_classes)."""

    def __init__(self, num_classes=1000):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for si, (width, blocks, stride) in enumerate(STAGES):
            layer = [Bottleneck(inplanes, width, stride, downsample=True)]
            layer += [Bottleneck(width * 4, width) for _ in range(blocks - 1)]
            setattr(self, f"layer{si + 1}", nn.Sequential(*layer))
            inplanes = width * 4
        self.fc = nn.Linear(inplanes, num_classes)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        for si in range(len(STAGES)):
            x = getattr(self, f"layer{si + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def init_torchvision_(model: ResNet50, generator: torch.Generator) -> ResNet50:
    """torchvision's initialisation, drawn on the CPU from ``generator``:
    convolutions kaiming-normal (fan_out, ReLU gain), BatchNorm weight 1,
    bias 0 and running statistics 0 / 1, the classifier Linear's default
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * math.sqrt(2.0 / fan_out))
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
            elif isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.weight.shape[1])
                for p in (m.weight, m.bias):
                    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
    return model


def load_resnet50(weights_path: Optional[str] = None, device="cuda",
                  generator: Optional[torch.Generator] = None) -> ResNet50:
    """ResNet-50 on ``device`` in eval mode: a torchvision ``.pth`` state
    dict at ``weights_path`` loaded strictly, or, without one or for a path
    that does not end in ``.pth`` (as the JAX package's ``load_variables``
    decides), torchvision's initialisation from ``generator`` (seeded with
    ``INIT_SEED`` if None).

    Without weights the features are meaningless, here as in the JAX
    package, and the two random towers differ: that one draws flax's init
    from ``PRNGKey(0)``.  Only their shapes agree."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = ResNet50()
    model = model.to_empty(device=dev)
    if weights_path and weights_path.endswith(".pth"):
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
    else:
        init_torchvision_(model, generator or torch.Generator().manual_seed(INIT_SEED))
    return model.eval()
