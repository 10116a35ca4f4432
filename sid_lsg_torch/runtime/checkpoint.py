"""Generator snapshots of the port, and the readers of every weight file it loads.

Port of ``sid_lsg_tpu/runtime/checkpoint.py`` (``export_generator``,
``load_generator_params``, the torch-pickle interop) and of the safetensors
reader of ``sid_lsg_tpu/models/convert.py``.  The safetensors format is read
and written by hand (the card's machine has no ``safetensors`` package): an
8-byte little-endian header length, a JSON header of dtype, shape and byte
offsets per tensor (plus an optional ``__metadata__`` entry), padded with
spaces to 8 bytes, then the raw little-endian bytes.

``export_generator`` writes the EMA generator under the port's keys, which
are the diffusers names, so the JAX package's ``load_generator_params(path,
unet_cfg)`` reads it through its HF converter.  ``load_generator_params``
reads three kinds of file into a port UNet state dict: the port's own export,
the JAX package's export (flax ``/`` keys, HWIO / (in, out) layout, carried
by ``models.convert.unet_params_from_jax``) and a torch pickle of the
reference (``network-snapshot-*.pkl`` holding ``{'ema': module}``, a training
state, a bare module or a ``.bin`` / ``.pt`` state dict), unpickled without
diffusers.

``CheckpointManager`` keeps the training-state dumps of a run (port of the
JAX package's orbax manager, on ``torch.save``): ``<dir>/<step>/state.pt``,
written under a temporary name and renamed into place, the newest five kept.
A JAX orbax dump cannot be read by it.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import struct
import sys
import types
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.configs import UNetConfig

_DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16",
           torch.int64: "I64"}
# Stored dtype -> (numpy dtype of the raw bytes, torch dtype to view them as).
# I64 is read for the ``position_ids`` buffer that transformers before 4.31
# saved with CLIP text towers.
_READ = {"F32": (np.float32, torch.float32), "F16": (np.float16, torch.float16),
         "BF16": (np.int16, torch.bfloat16), "I64": (np.int64, torch.int64)}


def _require_little_endian() -> None:
    if sys.byteorder != "little":
        raise RuntimeError("safetensors stores little-endian bytes; this host is big-endian")


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device) to ``path`` atomically."""
    _require_little_endian()
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


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A safetensors file -> CPU f32 tensors by key (F32, F16, BF16 and I64
    stored; any other dtype, or offsets that do not fit the file, raise)."""
    _require_little_endian()
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header of {n} bytes runs past the file ({len(raw)} bytes)")
    header = json.loads(raw[8:8 + n])
    body = memoryview(raw)[8 + n:]
    out = {}
    for key, meta in header.items():
        if key == "__metadata__":
            continue
        if meta["dtype"] not in _READ:
            raise ValueError(f"{path}: {key} has dtype {meta['dtype']}; the reader takes "
                             f"{sorted(_READ)}")
        np_dtype, dtype = _READ[meta["dtype"]]
        start, end = meta["data_offsets"]
        count = int(np.prod(meta["shape"], dtype=np.int64))
        if not 0 <= start <= end <= len(body) or end - start != count * np.dtype(np_dtype).itemsize:
            raise ValueError(f"{path}: {key}'s offsets [{start}, {end}) do not hold "
                             f"{meta['shape']} {meta['dtype']} in a body of {len(body)} bytes")
        arr = np.frombuffer(body[start:end], dtype=np_dtype).reshape(meta["shape"])
        out[key] = torch.from_numpy(arr.copy()).view(dtype).float()
    return out


def export_generator(params: Dict[str, torch.Tensor], path: str) -> None:
    """EMA generator params (diffusers keys) -> one safetensors file."""
    write_safetensors(params, path)


# ---------------------------------------------------------------------------
# Torch-pickle interop (no diffusers needed)

_STUB_MODULE_NAMES = [
    "diffusers",
    "diffusers.models",
    "diffusers.models.unets",
    "diffusers.models.unets.unet_2d_condition",
    "diffusers.models.unet_2d_condition",
    "dnnlib",
    "dnnlib.util",
    "torch_utils",
    "torch_utils.persistence",
]


@contextlib.contextmanager
def _stub_modules():
    """Install importable stand-ins for the modules a reference pickle names,
    for the length of the ``with`` block.

    Unpickling needs only *a* class of the pickled name: the object's state
    arrives by ``__setstate__`` with no ``__init__`` call, and an
    ``nn.Module`` keeps its tensors under ``_parameters``, ``_buffers`` and
    ``_modules``, which ``_walk_module_tree`` reads.  ``sys.modules`` is
    restored afterwards, so a stand-in never shadows a real import."""

    class _Stub:
        def __init__(self, *a, **k):
            pass

        def __setstate__(self, state):
            if isinstance(state, dict):
                self.__dict__.update(state)

    saved = {n: sys.modules.get(n) for n in _STUB_MODULE_NAMES}
    for mod_name in _STUB_MODULE_NAMES:
        if sys.modules.get(mod_name) is None:
            m = types.ModuleType(mod_name)
            m.__getattr__ = (  # type: ignore[assignment]
                lambda name, _m=mod_name: _Stub if name[:1].isupper()
                else types.ModuleType(f"{_m}.{name}"))
            sys.modules[mod_name] = m
    try:
        yield
    finally:
        for mod_name, prev in saved.items():
            if prev is None:
                sys.modules.pop(mod_name, None)
            else:
                sys.modules[mod_name] = prev


def _walk_module_tree(obj: Any, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """The tensors of an unpickled module object graph, by dotted name."""
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    for group in ("_parameters", "_buffers"):
        for name, t in (d.get(group) or {}).items():
            if t is not None:
                out[prefix + name] = t.detach().to("cpu").float()
    for name, child in (d.get("_modules") or {}).items():
        if child is not None:
            _walk_module_tree(child, f"{prefix}{name}.", out)


def torch_pickle_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference snapshot or state pickle -> CPU f32 tensors by key.

    Takes ``{'ema': module}`` snapshots, ``{'G': ..., 'G_ema': ...}``
    training states, bare modules and bare state dicts.  Unpickling runs
    code: read only files from a source you trust."""
    with _stub_modules():
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("ema", "G_ema", "G", "model", "state_dict"):
            if key in obj:
                obj = obj[key]
                break
    if isinstance(obj, dict):
        return {k: v.detach().to("cpu").float() for k, v in obj.items() if torch.is_tensor(v)}
    if isinstance(obj, torch.nn.Module):
        return {k: v.detach().to("cpu").float() for k, v in obj.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    _walk_module_tree(obj, "", out)
    if not out:
        raise ValueError(f"could not extract tensors from {path}")
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v.numpy()
    return tree


def load_generator_params(path: str, unet_cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """A generator file -> the port's UNet state dict (CPU, f32), its keys
    and shapes checked against ``unet_cfg``."""
    from ..models.convert import check_state_dict, unet_params_from_jax
    from ..models.unet import UNet2DCondition

    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory, not a generator file: a run directory of the "
                         "port resumes its training state with --resume <run dir>, and the JAX "
                         "package's orbax dumps cannot be read (ROADMAP Queue 1 item 5a); pass a "
                         ".safetensors, .pkl, .pt or .bin generator file")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"generator file {path!r} does not exist")
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
        if any("/" in k for k in sd):  # the JAX package's export: flax paths
            sd = unet_params_from_jax(_unflatten(sd), unet_cfg)
    else:
        sd = torch_pickle_state_dict(path)
    with torch.device("meta"):
        skeleton = UNet2DCondition(unet_cfg)
    check_state_dict(sd, skeleton, path)
    return sd


# ---------------------------------------------------------------------------
# Training-state dumps


def _detached(tree: Any) -> Any:
    if torch.is_tensor(tree):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree


def _check_like(loaded: Any, template: Any, path: str) -> None:
    """Raise ``KeyError`` where the dict keys differ and ``ValueError`` where a
    tensor's shape or dtype, or a leaf's kind, differs from ``template``."""
    where = path or "<root>"
    if isinstance(template, dict):
        if not isinstance(loaded, dict):
            raise ValueError(f"{where}: a dict in the template, {type(loaded).__name__} in the dump")
        if set(loaded) != set(template):
            missing, extra = sorted(set(template) - set(loaded)), sorted(set(loaded) - set(template))
            raise KeyError(f"{where}: keys differ from the template (missing {missing[:5]}, "
                           f"unexpected {extra[:5]})")
        for k in template:
            _check_like(loaded[k], template[k], f"{path}/{k}" if path else str(k))
    elif torch.is_tensor(template):
        if not torch.is_tensor(loaded):
            raise ValueError(f"{where}: a tensor in the template, {type(loaded).__name__} in the dump")
        if loaded.shape != template.shape or loaded.dtype != template.dtype:
            raise ValueError(f"{where}: {tuple(loaded.shape)} {loaded.dtype} in the dump, "
                             f"{tuple(template.shape)} {template.dtype} in the template")
    elif (template is None) != (loaded is None) or isinstance(loaded, (dict, torch.Tensor)):
        raise ValueError(f"{where}: {type(loaded).__name__} in the dump, "
                         f"{type(template).__name__} in the template")


@torch.no_grad()
def _fill(loaded: Any, template: Any) -> Any:
    """``template`` with each tensor overwritten in place by the dump's."""
    if isinstance(template, dict):
        return {k: _fill(loaded[k], v) for k, v in template.items()}
    if torch.is_tensor(template):
        return template.copy_(loaded)
    return loaded


class CheckpointManager:
    """Training-state dumps under ``directory``: ``<step>/state.pt``, one
    directory a step.

    ``save`` writes the tree (nested dicts of tensors, numbers, strings and
    None) with ``torch.save`` into a temporary directory, syncs it and renames
    it into place, so a half-written dump is never a step; the newest
    ``max_to_keep`` are kept.  ``restore(step, template)`` reads the file
    memory-mapped (``weights_only``) and, after checking every key, shape and
    dtype against ``template``, copies it tensor by tensor into the
    template's tensors, which it returns; the host never holds the dump
    twice.  Saves are synchronous: ``wait`` and ``close`` do nothing."""

    FILE = "state.pt"

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(os.path.join(self.directory, n, self.FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> str:
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, self.FILE)
        torch.save(_detached(tree), path)
        with open(path, "rb") as f:
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return os.path.join(final, self.FILE)

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no training-state dump under {self.directory}")
        path = os.path.join(self._step_dir(step), self.FILE)
        loaded = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        if template is None:
            return loaded
        _check_like(loaded, template, "")
        return _fill(loaded, template)

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass
