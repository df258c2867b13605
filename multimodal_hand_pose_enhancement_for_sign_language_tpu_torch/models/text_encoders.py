"""Text encoder towers: the BERT family (MiniLM / bert-base) and CLIP's text
transformer, in Hugging Face's key layouts.

The port's counterpart of the JAX package's ``models/text_encoders.py``
(the replacement of the reference's text featurizers, proc_text.py:57-100):

  * ``BertEncoder`` -- HF ``BertModel`` without its pooler: learned
    positions and token types, post-LN layers with exact erf GELU and
    eps 1e-12; ``output_hidden_states`` returns the embedding output and
    every layer's, so BERTword's last-four sum (proc_text.py:88-92) and
    BERTsentence's masked mean (``bert_mean_pool``) both read it.
  * ``CLIPTextEncoder`` -- HF ``CLIPTextModelWithProjection``: pre-LN
    layers with quickGELU, a causal mask, the final LayerNorm, pooling at
    the first ``eos_token_id`` (argmax of the ids when it is None) and a
    bias-free projection.

``state_dict`` keys are the published ones (``embeddings.*`` /
``encoder.layer.{i}.*``; ``text_model.*`` / ``text_projection.weight``),
so a snapshot's weights load with ``strict=True`` after ``bert_state`` /
``clip_text_state`` drop what the towers do not hold.  As in the JAX
package, masks are additive ``-1e9`` biases (not HF's dtype minimum) and
attention is a matmul and a softmax.  The JAX towers pin float32 matmuls
(``Precision.HIGHEST``); the data routes run these under
``infer.conv_matmul_precision("float32")`` (TF32 off).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    hf_snapshot,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)

NEG_INF = -1e9  # additive attention mask fill
INIT_STD = 0.02  # HF's initializer_range for both families


def _split_heads(x, n_heads):
    B, T, D = x.shape
    return x.reshape(B, T, n_heads, D // n_heads).transpose(1, 2)


def _merge_heads(x):
    B, H, T, Dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * Dh)


def attention(q, k, v, n_heads, bias=None):
    """(B, T, D) projections -> (B, T, D) context: scaled dot products plus
    an additive ``bias``, softmax, weighted sum over heads of D / n_heads."""
    q, k, v = (_split_heads(t, n_heads) for t in (q, k, v))
    logits = torch.matmul(q * (1.0 / math.sqrt(q.shape[-1])), k.transpose(-1, -2))
    if bias is not None:
        logits = logits + bias
    return _merge_heads(torch.matmul(torch.softmax(logits, dim=-1), v))


def init_weights_(module: nn.Module, generator: torch.Generator, std: float = INIT_STD):
    """HF's initialisation, drawn on the CPU from ``generator``: Linear,
    Embedding and Conv2d weights N(0, std), biases 0, LayerNorm 1 / 0, and
    any other parameter (CLIP's class embedding) N(0, std)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
            if isinstance(owner, nn.LayerNorm):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * std)
    return module


def materialize(make, device, state_dict=None, generator=None):
    """Build ``make()`` on ``device`` in eval mode without drawing from the
    global RNG: load ``state_dict`` strictly, or draw HF's init from
    ``generator``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        net = make()
    net = net.to_empty(device=dev)
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)
    else:
        init_weights_(net, generator)
    return net.eval()


# ---------------------------------------------------------------------------
# BERT family (bert-base-uncased, MiniLM-L6)
# ---------------------------------------------------------------------------


class BertLayer(nn.Module):
    """One post-LN BERT block (HF ``BertLayer``)."""

    def __init__(self, hidden_size, num_heads, intermediate_size, eps=1e-12):
        super().__init__()
        self.num_heads = num_heads
        self.attention = nn.ModuleDict({
            "self": nn.ModuleDict({n: nn.Linear(hidden_size, hidden_size)
                                   for n in ("query", "key", "value")}),
            "output": nn.ModuleDict({"dense": nn.Linear(hidden_size, hidden_size),
                                     "LayerNorm": nn.LayerNorm(hidden_size, eps=eps)}),
        })
        self.intermediate = nn.ModuleDict({"dense": nn.Linear(hidden_size, intermediate_size)})
        self.output = nn.ModuleDict({"dense": nn.Linear(intermediate_size, hidden_size),
                                     "LayerNorm": nn.LayerNorm(hidden_size, eps=eps)})

    def forward(self, h, bias):
        qkv = self.attention["self"]
        ctx = attention(qkv["query"](h), qkv["key"](h), qkv["value"](h), self.num_heads, bias)
        out = self.attention["output"]
        h = out["LayerNorm"](h + out["dense"](ctx))
        inter = F.gelu(self.intermediate["dense"](h))  # exact erf GELU
        return self.output["LayerNorm"](h + self.output["dense"](inter))


class BertEncoder(nn.Module):
    """HF ``BertModel`` (encoder only, no pooler).

    Returns the last hidden state; with ``output_hidden_states=True``,
    (last, hiddens) where ``hiddens`` starts with the embedding output, as
    HF's ``hidden_states`` tuple does."""

    def __init__(self, vocab_size, hidden_size=384, num_layers=6, num_heads=12,
                 intermediate_size=1536, max_position=512, type_vocab_size=2, eps=1e-12):
        super().__init__()
        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Embedding(vocab_size, hidden_size),
            "position_embeddings": nn.Embedding(max_position, hidden_size),
            "token_type_embeddings": nn.Embedding(type_vocab_size, hidden_size),
            "LayerNorm": nn.LayerNorm(hidden_size, eps=eps),
        })
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            [BertLayer(hidden_size, num_heads, intermediate_size, eps)
             for _ in range(num_layers)])})

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                output_hidden_states: bool = False):
        emb = self.embeddings
        T = input_ids.shape[1]
        if T > emb["position_embeddings"].num_embeddings:
            raise ValueError(f"{T} tokens exceed the tower's "
                             f"{emb['position_embeddings'].num_embeddings} positions")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = emb["position_embeddings"].weight[:T][None]
        h = emb["LayerNorm"](emb["word_embeddings"](input_ids) + pos
                             + emb["token_type_embeddings"](token_type_ids))
        bias = None
        if attention_mask is not None:
            bias = (1.0 - attention_mask[:, None, None, :].to(h.dtype)) * NEG_INF
        hiddens = [h]
        for layer in self.encoder["layer"]:
            h = layer(h, bias)
            hiddens.append(h)
        return (h, hiddens) if output_hidden_states else h


def bert_mean_pool(last_hidden, attention_mask):
    """sentence-transformers' masked mean pooling."""
    mask = attention_mask[..., None].to(last_hidden.dtype)
    return (last_hidden * mask).sum(1) / mask.sum(1).clamp(min=1e-9)


# buffers of older BertModel dumps, not weights
_BERT_BUFFERS = ("embeddings.position_ids", "embeddings.token_type_ids")


def bert_state(state_dict) -> dict:
    """A BertModel dump in ``BertEncoder``'s keys: a ``bert.`` prefix is
    stripped (keys without it are then dropped, as ``bert_from_hf_state``
    does), the pooler and the position-id buffers are dropped."""
    sd = dict(state_dict)
    if any(k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):]: v for k, v in sd.items() if k.startswith("bert.")}
    return {k: v for k, v in sd.items()
            if not k.startswith("pooler.") and k not in _BERT_BUFFERS}


def bert_config_from_state(sd: dict, num_heads: int = 12) -> dict:
    """``BertEncoder`` kwargs from a state dict.  The head count is not in
    the weights' shapes and must be given (a snapshot's config.json has it)."""
    sd = bert_state(sd)
    vocab, hidden = sd["embeddings.word_embeddings.weight"].shape
    n_layers = 0
    while f"encoder.layer.{n_layers}.attention.self.query.weight" in sd:
        n_layers += 1
    return dict(
        vocab_size=int(vocab),
        hidden_size=int(hidden),
        num_layers=n_layers,
        num_heads=num_heads,
        intermediate_size=int(sd["encoder.layer.0.intermediate.dense.weight"].shape[0]),
        max_position=int(sd["embeddings.position_embeddings.weight"].shape[0]),
        type_vocab_size=int(sd["embeddings.token_type_embeddings.weight"].shape[0]),
    )


def load_bert(model_dir: str, device="cuda") -> BertEncoder:
    """A BERT snapshot (config.json and its weights) as a ``BertEncoder``
    on ``device``, loaded strictly; the head count from config.json."""
    sd = bert_state(hf_snapshot.read_state(model_dir))
    heads = hf_snapshot.read_config(model_dir)["num_attention_heads"]
    cfg = bert_config_from_state(sd, num_heads=heads)
    return materialize(lambda: BertEncoder(**cfg), device, state_dict=sd)


# ---------------------------------------------------------------------------
# CLIP text transformer (ViT-B/32 text tower)
# ---------------------------------------------------------------------------


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPLayer(nn.Module):
    """One pre-LN CLIP block (HF ``CLIPEncoderLayer``), shared by the text
    and vision towers."""

    def __init__(self, hidden_size, num_heads, intermediate_size, eps=1e-5):
        super().__init__()
        self.num_heads = num_heads
        self.self_attn = nn.ModuleDict({n: nn.Linear(hidden_size, hidden_size)
                                        for n in ("q_proj", "k_proj", "v_proj", "out_proj")})
        self.layer_norm1 = nn.LayerNorm(hidden_size, eps=eps)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(hidden_size, intermediate_size),
                                  "fc2": nn.Linear(intermediate_size, hidden_size)})
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=eps)

    def forward(self, h, bias):
        a = self.self_attn
        x = self.layer_norm1(h)
        h = h + a["out_proj"](attention(a["q_proj"](x), a["k_proj"](x), a["v_proj"](x),
                                        self.num_heads, bias))
        x = quick_gelu(self.mlp["fc1"](self.layer_norm2(h)))
        return h + self.mlp["fc2"](x)


class CLIPTextEncoder(nn.Module):
    """CLIP's text tower with its projection (``encode_text``)."""

    def __init__(self, vocab_size=49408, hidden_size=512, num_layers=12, num_heads=8,
                 intermediate_size=2048, max_position=77, projection_dim=512, eps=1e-5,
                 eos_token_id=49407):
        super().__init__()
        self.eos_token_id = eos_token_id
        self.text_model = nn.ModuleDict({
            "embeddings": nn.ModuleDict({
                "token_embedding": nn.Embedding(vocab_size, hidden_size),
                "position_embedding": nn.Embedding(max_position, hidden_size),
            }),
            "encoder": nn.ModuleDict({"layers": nn.ModuleList(
                [CLIPLayer(hidden_size, num_heads, intermediate_size, eps)
                 for _ in range(num_layers)])}),
            "final_layer_norm": nn.LayerNorm(hidden_size, eps=eps),
        })
        self.text_projection = nn.Linear(hidden_size, projection_dim, bias=False)

    def forward(self, input_ids, return_hidden: bool = False):
        tm = self.text_model
        B, T = input_ids.shape
        h = (tm["embeddings"]["token_embedding"](input_ids)
             + tm["embeddings"]["position_embedding"].weight[:T][None])
        causal = torch.full((T, T), NEG_INF, dtype=h.dtype, device=h.device).triu(1)[None, None]
        for layer in tm["encoder"]["layers"]:
            h = layer(h, causal)
        h = tm["final_layer_norm"](h)
        if self.eos_token_id is None:
            eos_pos = input_ids.argmax(-1)
        else:
            eos_pos = (input_ids == self.eos_token_id).to(torch.int32).argmax(-1)
        out = self.text_projection(h[torch.arange(B, device=h.device), eos_pos])
        return (out, h) if return_hidden else out


def clip_text_state(state_dict) -> dict:
    """The text tower's keys of a ``CLIPTextModelWithProjection`` or a full
    ``CLIPModel`` dump: ``text_model.*`` and ``text_projection.weight``,
    without the position-id buffer."""
    return {k: v for k, v in state_dict.items()
            if (k.startswith("text_model.") or k == "text_projection.weight")
            and k != "text_model.embeddings.position_ids"}


def load_clip_text(model_dir: str, eos_token_id, device="cuda") -> CLIPTextEncoder:
    """A CLIP snapshot's text tower on ``device``, loaded strictly; widths
    from the weights, pooling at ``eos_token_id`` (the tokenizer's).  The
    head count is ``hidden // 64``, as the JAX package's clip route takes
    it, whatever config.json says (both give 8 for ViT-B/32)."""
    sd = clip_text_state(hf_snapshot.read_state(model_dir))
    n_layers = 0
    while f"text_model.encoder.layers.{n_layers}.self_attn.q_proj.weight" in sd:
        n_layers += 1
    vocab, hidden = sd["text_model.embeddings.token_embedding.weight"].shape
    kw = dict(
        vocab_size=int(vocab),
        hidden_size=int(hidden),
        num_layers=n_layers,
        num_heads=int(hidden) // 64,
        intermediate_size=int(sd["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0]),
        max_position=int(sd["text_model.embeddings.position_embedding.weight"].shape[0]),
        projection_dim=int(sd["text_projection.weight"].shape[0]),
        eos_token_id=eos_token_id,
    )
    return materialize(lambda: CLIPTextEncoder(**kw), device, state_dict=sd)
