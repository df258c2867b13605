"""Weights bridge: the JAX package's generator variables -> this port's state_dict.

The JAX generators keep flax trees ``{'params': ..., 'batch_stats': ...}``
of numpy arrays; this maps them onto the reference's ``nn.Sequential`` key
layout (``encoder.1.weight``, ``decoder.5.weight``, ...), the same mapping
as the JAX package's ``models/torch_port.generator_to_torch_state``:

  * Conv1d     flax (k, in, out) -> torch (out, in, k)
  * ConvT1d    flax (k, in, out) -> torch (in, out, k)
  * Dense      flax (in, out)    -> torch (out, in)
  * BatchNorm  scale/bias -> weight/bias; mean/var -> running_mean/var;
    ``num_batches_tracked`` is 0 (eval uses the running statistics as is).
"""

from __future__ import annotations

import numpy as np
import torch

# block names shared by the JAX tree and the reference state_dict
GEN_BLOCKS = (
    "encoder", "conv5", "conv6", "conv7", "conv8", "conv9", "conv10",
    "skip1", "skip2", "skip3", "skip4", "skip5",
)
FEAT_BLOCKS = ("text_embeds_postprocess", "image_resnet_postprocess")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def _conv(out, block):
    return {
        f"{out}.weight": _t(np.transpose(np.asarray(block["kernel"]), (2, 1, 0))),
        f"{out}.bias": _t(block["bias"]),
    }


def _conv_t(out, block):
    return {
        f"{out}.weight": _t(np.transpose(np.asarray(block["kernel"]), (1, 2, 0))),
        f"{out}.bias": _t(block["bias"]),
    }


def _dense(out, block):
    return {
        f"{out}.weight": _t(np.transpose(np.asarray(block["kernel"]), (1, 0))),
        f"{out}.bias": _t(block["bias"]),
    }


def _bn(out, params, stats):
    return {
        f"{out}.weight": _t(params["scale"]),
        f"{out}.bias": _t(params["bias"]),
        f"{out}.running_mean": _t(stats["mean"]),
        f"{out}.running_var": _t(stats["var"]),
        f"{out}.num_batches_tracked": torch.tensor(0, dtype=torch.int64),
    }


def _conv_block(name, params, stats, conv_idx=1, bn_idx=3):
    sd = _conv(f"{name}.{conv_idx}", params["Conv1d_0"])
    sd.update(_bn(f"{name}.{bn_idx}", params["BatchNorm_0"], stats["BatchNorm_0"]))
    return sd


def generator_state_dict(variables) -> dict:
    """``{'params', 'batch_stats'}`` tree of numpy arrays -> state_dict of
    CPU tensors in the reference key layout."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for name in GEN_BLOCKS:
        if name in params:
            sd.update(_conv_block(name, params[name], stats[name]))
    for name in FEAT_BLOCKS:
        if name in params:
            sd.update(_dense(f"{name}.1", params[name]["Dense_0"]))
            sd.update(_bn(f"{name}.3", params[name]["BatchNorm_0"],
                          stats[name]["BatchNorm_0"]))
    dec_p, dec_s = params["decoder"], stats["decoder"]
    sd.update(_conv_block("decoder", dec_p["ConvBlock_0"], dec_s["ConvBlock_0"]))
    sd.update(_conv_t("decoder.5", dec_p["ConvTranspose1d_0"]))
    sd.update(_bn("decoder.7", dec_p["BatchNorm_0"], dec_s["BatchNorm_0"]))
    sd.update(_conv("decoder.9", dec_p["Conv1d_0"]))
    return sd
