"""Generator snapshots of the port.

Port of ``export_generator`` from ``sid_lsg_tpu/runtime/checkpoint.py``: the
EMA generator as one safetensors file.  The keys are the diffusers names of
the port's state dicts, so the JAX package's ``load_generator_params(path,
unet_cfg)`` reads it through its HF converter.  The format is written by
hand (the card's machine has no ``safetensors`` package): an 8-byte
little-endian header length, a JSON header of dtype, shape and byte offsets
per tensor, padded with spaces to 8 bytes, then the raw little-endian bytes.
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Dict

import torch

_DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16"}


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device) to ``path`` atomically."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors stores little-endian bytes; this host is big-endian")
    header, blobs, offset = {}, [], 0
    for key in sorted(tensors):
        t = tensors[key].detach()
        if t.dtype not in _DTYPES:
            raise TypeError(f"{key}: no safetensors dtype for {t.dtype}")
        data = t.cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[key] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)
    os.replace(tmp, path)


def export_generator(params: Dict[str, torch.Tensor], path: str) -> None:
    """EMA generator params (diffusers keys) -> one safetensors file."""
    write_safetensors(params, path)
