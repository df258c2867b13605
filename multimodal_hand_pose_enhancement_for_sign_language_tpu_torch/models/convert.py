"""Weights bridge: the JAX package's model variables -> this port's state_dicts.

The JAX generators keep flax trees ``{'params': ..., 'batch_stats': ...}``
of numpy arrays; this maps them onto the reference's ``nn.Sequential`` key
layout (``encoder.1.weight``, ``decoder.5.weight``, ...), the same mapping
as the JAX package's ``models/torch_port.generator_to_torch_state``:

  * Conv1d     flax (k, in, out) -> torch (out, in, k)
  * ConvT1d    flax (k, in, out) -> torch (in, out, k)
  * Conv2d     flax (kh, kw, in, out) -> torch (out, in, kh, kw)
  * Dense      flax (in, out)    -> torch (out, in)
  * LayerNorm  scale/bias -> weight/bias
  * BatchNorm  scale/bias -> weight/bias; mean/var -> running_mean/var;
    ``num_batches_tracked`` is 0 (eval uses the running statistics as is).

The featurizer towers map onto their published layouts (HF ``BertModel``,
``CLIPModel``'s text and vision towers, torchvision's ``resnet50``): the
inverses of the JAX package's ``bert_from_hf_state``,
``clip_text_from_hf_state``, ``clip_vision_from_hf_state`` and
``from_torchvision_state``.
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


def discriminator_state_dict(variables) -> dict:
    """The discriminator's ``{'params', 'batch_stats'}`` tree -> state_dict
    in the reference's ``convs.<i>`` layout (convs 1, 5, ..., 25 and 29), the
    mapping of the JAX package's ``torch_port.discriminator_to_torch_state``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for i in range(7):
        conv_idx = 1 + 4 * i
        sd.update(_conv_block("convs", params[f"block{i}"], stats[f"block{i}"],
                              conv_idx, conv_idx + 2))
    sd.update(_conv("convs.29", params["final"]))
    return sd


def robust_state_dict(robust_params) -> dict:
    """The adaptive loss's latent tree -> ``AdaptiveLossFunction`` state_dict."""
    return {k: _t(robust_params[k]) for k in ("latent_alpha", "latent_scale")
            if k in robust_params}


_GATES = ("i", "f", "g", "o")  # nn.LSTM's gate order in weight_ih / weight_hh


def classifier_state_dict(params) -> dict:
    """The JAX ``ClassifLSTM`` params tree -> state_dict in the reference's
    ``nn.LSTM`` + ``Linear`` layout, the inverse of the JAX package's
    ``torch_port.classifier_from_torch_state``.  Cell ``lstm{k}_{f|b}_cell``
    holds per-gate input kernels ``i{gate}.kernel`` (in + 1, H) whose last
    row is ``bias_ih`` (the JAX model appends a constant-1 input column) and
    recurrent ``h{gate}.{kernel, bias}`` (H, H), (H,): the weights ``_hh``
    and ``bias_hh``."""
    sd: dict = {}
    k = 0
    while f"lstm{k}_f_cell" in params:
        for tag, suffix in (("f", ""), ("b", "_reverse")):
            cell = params.get(f"lstm{k}_{tag}_cell")
            if cell is None:
                continue
            w_i = [np.asarray(cell[f"i{g}"]["kernel"]) for g in _GATES]
            sd[f"lstm.weight_ih_l{k}{suffix}"] = _t(np.concatenate([w[:-1].T for w in w_i]))
            sd[f"lstm.weight_hh_l{k}{suffix}"] = _t(np.concatenate(
                [np.asarray(cell[f"h{g}"]["kernel"]).T for g in _GATES]))
            sd[f"lstm.bias_ih_l{k}{suffix}"] = _t(np.concatenate([w[-1] for w in w_i]))
            sd[f"lstm.bias_hh_l{k}{suffix}"] = _t(np.concatenate(
                [np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES]))
        k += 1
    sd.update(_dense("Linear", params["Linear"]))
    return sd


def sentence_classifier_state_dict(params) -> dict:
    """The JAX ``SentenceClassifier`` params (``fc1``, ``fc2``) -> the
    reference's ``classifier.0`` / ``classifier.2`` layout."""
    return {**_dense("classifier.0", params["fc1"]), **_dense("classifier.2", params["fc2"])}


# ---------------------------------------------------------------------------
# featurizer towers
# ---------------------------------------------------------------------------


def _ln(out, block):
    return {f"{out}.weight": _t(block["scale"]), f"{out}.bias": _t(block["bias"])}


def _conv2d(block):
    return _t(np.transpose(np.asarray(block["kernel"]), (3, 2, 0, 1)))


def _layers(params, base, names):
    """Every ``layer{i}`` block of a flax transformer, each sub-block named by
    ``names`` (flax name -> torch suffix, Dense or LayerNorm by its keys)."""
    sd: dict = {}
    i = 0
    while f"layer{i}" in params:
        for flax_name, torch_name in names.items():
            block = params[f"layer{i}"][flax_name]
            key = f"{base}.{i}.{torch_name}"
            sd.update(_ln(key, block) if "scale" in block else _dense(key, block))
        i += 1
    return sd


_BERT_LAYER = {"q": "attention.self.query", "k": "attention.self.key",
               "v": "attention.self.value", "attn_out": "attention.output.dense",
               "attn_ln": "attention.output.LayerNorm", "fc1": "intermediate.dense",
               "fc2": "output.dense", "out_ln": "output.LayerNorm"}
_CLIP_LAYER = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
               "attn_out": "self_attn.out_proj", "ln1": "layer_norm1", "ln2": "layer_norm2",
               "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def bert_state_dict(variables) -> dict:
    """The JAX ``BertEncoder``'s variables -> HF ``BertModel`` keys."""
    p = variables["params"]
    sd = {f"embeddings.{n}.weight": _t(p[n]["embedding"])
          for n in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    sd.update(_ln("embeddings.LayerNorm", p["embeddings_ln"]))
    sd.update(_layers(p, "encoder.layer", _BERT_LAYER))
    return sd


def clip_text_state_dict(variables) -> dict:
    """The JAX ``CLIPTextEncoder``'s variables -> ``text_model.*`` and
    ``text_projection.weight``."""
    p = variables["params"]
    sd = {"text_model.embeddings.token_embedding.weight": _t(p["token_embedding"]["embedding"]),
          "text_model.embeddings.position_embedding.weight": _t(p["position_embedding"]),
          "text_projection.weight": _t(np.transpose(np.asarray(p["text_projection"]), (1, 0)))}
    sd.update(_ln("text_model.final_layer_norm", p["final_ln"]))
    sd.update(_layers(p, "text_model.encoder.layers", _CLIP_LAYER))
    return sd


def clip_vision_state_dict(variables) -> dict:
    """The JAX ``CLIPVisionEncoder``'s variables -> ``vision_model.*`` (HF's
    ``pre_layrnorm`` spelling) and ``visual_projection.weight``."""
    p = variables["params"]
    pre = "vision_model."
    sd = {f"{pre}embeddings.class_embedding": _t(p["class_embedding"]),
          f"{pre}embeddings.patch_embedding.weight": _conv2d(p["patch_embedding"]),
          f"{pre}embeddings.position_embedding.weight": _t(p["position_embedding"]),
          "visual_projection.weight": _t(np.transpose(np.asarray(p["visual_projection"]),
                                                      (1, 0)))}
    sd.update(_ln(f"{pre}pre_layrnorm", p["pre_ln"]))
    sd.update(_ln(f"{pre}post_layernorm", p["post_ln"]))
    sd.update(_layers(p, f"{pre}encoder.layers", _CLIP_LAYER))
    return sd


def resnet50_state_dict(variables) -> dict:
    """The JAX ``ResNet50``'s ``{'params', 'batch_stats'}`` -> torchvision's
    ``resnet50`` keys."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {"conv1.weight": _conv2d(params["conv1"])}
    sd.update(_bn("bn1", params["bn1"], stats["bn1"]))
    for name, block in params.items():
        if not name.startswith("layer"):
            continue
        out = name.replace("_", ".")  # layer{s}_{b} -> layer{s}.{b}
        for ci in (1, 2, 3):
            sd[f"{out}.conv{ci}.weight"] = _conv2d(block[f"conv{ci}"])
            sd.update(_bn(f"{out}.bn{ci}", block[f"bn{ci}"], stats[name][f"bn{ci}"]))
        if "downsample_conv" in block:
            sd[f"{out}.downsample.0.weight"] = _conv2d(block["downsample_conv"])
            sd.update(_bn(f"{out}.downsample.1", block["downsample_bn"],
                          stats[name]["downsample_bn"]))
    sd.update(_dense("fc", params["fc"]))
    return sd
