"""Local Hugging Face snapshots, read without ``transformers``.

The JAX package reads a snapshot directory through ``AutoConfig`` /
``AutoModel`` and ``text_encoders.load_torch_state``; the port reads the
same files itself, so that a featurizer runs on a machine without
``transformers`` or ``safetensors``:

  * ``config.json`` -- the model's configuration (a ``CLIPModel`` nests
    ``text_config`` and ``vision_config``),
  * ``model.safetensors`` -- parsed here: an 8-byte little-endian header
    length, a JSON header of ``{name: {dtype, shape, data_offsets}}`` (and
    an optional ``__metadata__``), then the raw tensor bytes,
  * ``pytorch_model.bin`` -- ``torch.load(weights_only=True)``.

Tensors keep the file's dtype; ``load_state_dict`` casts them into a
float32 tower.
"""

from __future__ import annotations

import json
import math
import os
import struct

import torch

WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")

# safetensors dtype names; I64 for the position-id buffers of older dumps
_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
}


def read_config(model_dir: str) -> dict:
    """The snapshot's ``config.json``."""
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def read_safetensors(path: str) -> dict:
    """``{name: tensor}`` from a ``.safetensors`` file, on the CPU.

    The tensors are views of one buffer holding the file's bytes; raises
    ``ValueError`` on a header that does not fit the file or names a dtype
    outside F32, F16, BF16 and I64."""
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    if len(buf) < 8:
        raise ValueError(f"{path}: shorter than a safetensors header")
    (n_header,) = struct.unpack("<Q", bytes(buf[:8]))
    start = 8 + n_header
    if start > len(buf):
        raise ValueError(f"{path}: header of {n_header} bytes exceeds the file")
    header = json.loads(bytes(buf[8:start]))
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']!r}; "
                             f"read: {sorted(_DTYPES)}")
        dtype = _DTYPES[info["dtype"]]
        shape = [int(s) for s in info["shape"]]
        lo, hi = (int(o) for o in info["data_offsets"])
        numel = math.prod(shape)
        if hi - lo != numel * dtype.itemsize or start + hi > len(buf):
            raise ValueError(f"{path}: tensor {name!r} offsets {lo}..{hi} do not hold "
                             f"{shape} {info['dtype']}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=numel,
                                         offset=start + lo).reshape(shape)
    return out


def read_state(model_dir: str) -> dict:
    """The snapshot's weights as ``{name: CPU tensor}``: ``model.safetensors``
    if present, else ``pytorch_model.bin``."""
    for name in WEIGHT_FILES:
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            if name.endswith(".safetensors"):
                return read_safetensors(path)
            sd = torch.load(path, map_location="cpu", weights_only=True)
            return dict(sd.state_dict() if hasattr(sd, "state_dict") else sd)
    raise FileNotFoundError(f"{model_dir}: no {' or '.join(WEIGHT_FILES)}")
