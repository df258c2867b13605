"""Downstream classifiers: the LSTM topic classifier and the sentence MLP.

PyTorch counterparts of the JAX package's ``models/classifier.py``:

  * ``ClassifLSTM`` -- H2Sclassifier/Model/ClassifLSTM.py:5-26: a stack of
    (optionally bidirectional) LSTM layers over r6d sequences and a Linear
    head to per-timestep logits.  Every LSTM tensor is U(-1/sqrt(H),
    1/sqrt(H)); dropout sits between layers, never after the last one.
  * ``SentenceClassifier`` -- H2Sclassifier/Train_Test/MLP_main.py:17-28:
    Linear(384 -> 256) -> ReLU -> Linear(256 -> 10) -> Sigmoid.

Both keep the reference's state_dict keys (``lstm.weight_ih_l{k}[_reverse]``,
``lstm.bias_hh_l{k}[_reverse]``, ``Linear.*``; ``classifier.0.*``,
``classifier.2.*``), so a reference ``.pth`` loads with ``strict=True``.

The LSTM runs one single-layer ``nn.LSTM`` (one cuDNN call on a CUDA
device) per layer, with the port's ``Dropout`` between layers: a stacked
``nn.LSTM(num_layers=L, dropout=p)`` would draw its inter-layer masks
inside cuDNN from the global generator, where these come from the
trainer's own ``torch.Generator``.  State-dict hooks rename the layers'
``lstm.<k>.weight_ih_l0`` to the reference's ``lstm.weight_ih_l<k>`` and
back.  With ``remat=True`` each layer runs under ``torch.utils.checkpoint``:
its activations are recomputed in the backward pass instead of kept.
"""

from __future__ import annotations

import math
import re

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.layers import (
    Dropout,
    init_torch_default_,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)

# lstm.<layer>.<name>_l0[_reverse] (the modules) <-> lstm.<name>_l<layer>[_reverse]
_OWN_KEY = re.compile(r"^lstm\.(\d+)\.(weight_ih|weight_hh|bias_ih|bias_hh)_l0(_reverse)?$")
_REF_KEY = re.compile(r"^lstm\.(weight_ih|weight_hh|bias_ih|bias_hh)_l(\d+)(_reverse)?$")


def _to_reference_keys(module, state_dict, prefix, local_metadata):
    items = list(state_dict.items())  # renamed in place, in the same order
    state_dict.clear()
    for key, value in items:
        m = _OWN_KEY.match(key[len(prefix):]) if key.startswith(prefix) else None
        if m:
            layer, name, rev = m.groups()
            key = f"{prefix}lstm.{name}_l{layer}{rev or ''}"
        state_dict[key] = value


def _from_reference_keys(module, state_dict, prefix, *args):
    for key in [k for k in state_dict if k.startswith(prefix)]:
        m = _REF_KEY.match(key[len(prefix):])
        if m:
            name, layer, rev = m.groups()
            state_dict[f"{prefix}lstm.{layer}.{name}_l0{rev or ''}"] = state_dict.pop(key)


class ClassifLSTM(nn.Module):
    """(B, T, input_size) -> (B, T, num_classes) per-timestep logits."""

    def __init__(self, input_size: int, hidden_size: int = 1024, num_layers: int = 10,
                 num_classes: int = 10, bidirectional: bool = True,
                 dropout: float = 0.0, remat: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.remat = remat
        dirs = 2 if bidirectional else 1
        self.lstm = nn.ModuleList(
            nn.LSTM(input_size if k == 0 else dirs * hidden_size, hidden_size,
                    batch_first=True, bidirectional=bidirectional)
            for k in range(num_layers)
        )
        self.drop = Dropout(dropout)
        self.Linear = nn.Linear(dirs * hidden_size, num_classes)
        self.register_state_dict_post_hook(_to_reference_keys)
        self.register_load_state_dict_pre_hook(_from_reference_keys)

    def forward(self, seq):
        h = seq
        last = len(self.lstm) - 1
        for k, layer in enumerate(self.lstm):
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(lambda x, layer=layer: layer(x)[0], h,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                h = layer(h)[0]
            if k < last:
                h = self.drop(h)
        return self.Linear(h)


class SentenceClassifier(nn.Module):
    """(B, in_dim) sentence embeddings -> (B, num_classes) sigmoid scores."""

    def __init__(self, in_dim: int = 384, hidden: int = 256, num_classes: int = 10):
        super().__init__()
        self.classifier = nn.Sequential(
            nn.Linear(in_dim, hidden), nn.ReLU(),
            nn.Linear(hidden, num_classes), nn.Sigmoid(),
        )

    def forward(self, x):
        return self.classifier(x)


@torch.no_grad()
def init_classifier_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initialisation, drawn from ``generator`` on the CPU:
    every LSTM tensor U(-1/sqrt(H), 1/sqrt(H)) in ``nn.LSTM``'s parameter
    order, layer by layer; every Linear PyTorch's default (as the JAX
    ``Dense``)."""
    for m in module.modules():
        if isinstance(m, nn.LSTM):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                vals = torch.rand(p.shape, generator=generator) * (2 * bound) - bound
                p.copy_(vals)
        elif isinstance(m, nn.Linear):
            init_torch_default_(m, generator)
    return module


def build_classifier(kind: str, seed: int = 1, device="cuda", **kwargs) -> nn.Module:
    """``ClassifLSTM`` (kind "lstm") or ``SentenceClassifier`` ("mlp") on
    ``device`` in eval mode, its weights from ``torch.Generator`` seeded with
    ``seed``."""
    cls = {"lstm": ClassifLSTM, "mlp": SentenceClassifier}[kind]
    dev = resolve_device(device)
    with torch.device("meta"):  # no default initialisation to overwrite
        net = cls(**kwargs)
    net = init_classifier_(net.to_empty(device="cpu"), torch.Generator().manual_seed(seed))
    return net.to(dev).eval()
