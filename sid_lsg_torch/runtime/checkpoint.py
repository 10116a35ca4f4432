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
It does not read a JAX orbax dump: ``scripts/jax_dump_to_torch.py`` (run
where the JAX package runs) restores one and writes it as a port dump through
``state_from_jax``, and every reader here that meets an orbax dump raises
naming that script.
"""

from __future__ import annotations

import contextlib
import json
import mmap
import os
import shutil
import struct
import sys
import types
from typing import Any, Dict, Iterable, List, Optional, Tuple

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


JAX_DUMP_SCRIPT = "scripts/jax_dump_to_torch.py"
_CONVERT_HINT = (f"convert a JAX run's orbax dump with `python {JAX_DUMP_SCRIPT} <JAX run dir> "
                 "<port run dir>` where the JAX package runs, then resume the port with "
                 "--resume <port run dir>")


def refuse_orbax(directory: str) -> None:
    """Raise, naming the conversion script, when ``directory`` (a run
    directory, its ``checkpoints`` or one step) holds a JAX orbax dump and
    no port ``state.pt``."""
    def orbax(step_dir: str) -> bool:
        return ((os.path.isfile(os.path.join(step_dir, "_CHECKPOINT_METADATA"))
                 or os.path.isdir(os.path.join(step_dir, "default")))
                and not os.path.isfile(os.path.join(step_dir, CheckpointManager.FILE)))

    candidates = [directory]
    for parent in (directory, os.path.join(directory, "checkpoints")):
        if os.path.isdir(parent):
            candidates += [os.path.join(parent, n) for n in sorted(os.listdir(parent))
                           if n.isdigit()]
    found = [c for c in candidates if orbax(c)]
    if found:
        raise ValueError(f"{found[-1]} is a JAX orbax dump, which the port does not read: "
                         + _CONVERT_HINT)


def load_generator_params(path: str, unet_cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """A generator file -> the port's UNet state dict (CPU, f32), its keys
    and shapes checked against ``unet_cfg``."""
    from ..models.convert import check_state_dict, unet_params_from_jax
    from ..models.unet import UNet2DCondition

    if os.path.isdir(path):
        refuse_orbax(path)
        raise ValueError(f"{path} is a directory, not a generator file: a run directory of the "
                         "port resumes its training state with --resume <run dir>; "
                         + _CONVERT_HINT + "; or pass a .safetensors, .pkl, .pt or .bin "
                         "generator file")
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


def check_like(loaded: Any, template: Any, path: str = "") -> None:
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
            check_like(loaded[k], template[k], f"{path}/{k}" if path else str(k))
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
def fill_like(loaded: Any, template: Any) -> Any:
    """``template`` with each tensor overwritten in place by the dump's."""
    if isinstance(template, dict):
        return {k: fill_like(loaded[k], v) for k, v in template.items()}
    if torch.is_tensor(template):
        return template.copy_(loaded)
    return loaded


def _stand_ins(tree: Any) -> Any:
    """``tree`` with each tensor on the meta device replaced by a CPU stand-in
    that has a shape and no storage (a fake tensor)."""
    if isinstance(tree, dict):
        return {k: _stand_ins(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stand_ins(v) for v in tree)
    if torch.is_tensor(tree) and tree.device.type == "meta":
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            return torch.empty(tree.shape, dtype=tree.dtype)
    return tree


@torch.no_grad()
def _copy_real(tree: Any, mapped: Any) -> None:
    """Every tensor of ``tree`` not on the meta device into ``mapped``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _copy_real(v, mapped[k])
    elif isinstance(tree, (list, tuple)):
        for v, m in zip(tree, mapped):
            _copy_real(v, m)
    elif torch.is_tensor(tree) and tree.device.type != "meta":
        mapped.copy_(tree)


def save_in_parts(tree: Any, parts: Iterable[Tuple[Tuple[str, ...], Dict[str, torch.Tensor]]],
                  path: str) -> None:
    """``torch.save(tree, path)`` where the tensors on the meta device are
    given later, one dict at a time: ``parts`` yields ``(keys, tensors)``, the
    dict at the key path ``keys`` of ``tree`` in full.  The file is written
    with room for every tensor's bytes and no bytes, then mapped shared, and
    each tensor is copied into it: ``tree``'s own, then each part as it is
    yielded (and dropped), so the host never holds more than one part."""
    with torch.serialization.skip_data(materialize_fake_tensors=True):
        torch.save(_stand_ins(_detached(tree)), path)
    with torch.serialization.set_default_mmap_options(mmap.MAP_SHARED):
        mapped = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    _copy_real(tree, mapped)
    for keys, tensors in parts:
        dst = mapped
        for k in keys:
            dst = dst[k]
        check_like(tensors, dst, "/".join(keys))
        fill_like(tensors, dst)
        del tensors
    del mapped


class CheckpointManager:
    """Training-state dumps under ``directory``: ``<step>/state.pt``, one
    directory a step.

    ``save`` writes the tree (nested dicts of tensors, numbers, strings and
    None) with ``torch.save``, or part by part (``save_in_parts``), into a
    temporary directory, syncs it and renames
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

    def save(self, step: int, tree: Any, parts: Optional[Iterable] = None) -> str:
        """Write ``tree`` as ``<step>/state.pt`` (``parts``: its tensors on
        the meta device, given a dict at a time, as ``save_in_parts`` says)."""
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, self.FILE)
        if parts is None:
            torch.save(_detached(tree), path)
        else:
            save_in_parts(tree, parts, path)
        with open(path, "rb") as f:
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return os.path.join(final, self.FILE)

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None or not os.path.isfile(os.path.join(self._step_dir(step), self.FILE)):
            refuse_orbax(self.directory if step is None else self._step_dir(step))
        if step is None:
            raise FileNotFoundError(f"no training-state dump under {self.directory}")
        path = os.path.join(self._step_dir(step), self.FILE)
        loaded = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        if template is None:
            return loaded
        check_like(loaded, template, "")
        return fill_like(loaded, template)

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# A JAX run's training state -> a port dump

# What a converted dump says of itself (its ``converted_from`` entry).
JAX_ORIGIN = ("a JAX orbax dump: the step generator and the data iterators start from their "
              "seeds, since the two packages draw differently")


def _np_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def _adam_state(opt: Any) -> dict:
    """The Adam state (``count``, ``mu``, ``nu``) inside an optax chain's state."""
    if isinstance(opt, dict):
        if {"count", "nu"} <= set(opt):
            return opt
        found = [_adam_state(v) for v in opt.values()]
    elif isinstance(opt, (list, tuple)):
        found = [_adam_state(v) for v in opt]
    else:
        return None
    found = [f for f in found if f is not None]
    if len(found) > 1:
        raise ValueError("the optimizer state holds more than one Adam state")
    return found[0] if found else None


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def state_from_jax(tree: dict, unet_cfg: UNetConfig) -> dict:
    """A restored JAX training dump (numpy leaves) -> the tree the port's
    ``CheckpointManager`` writes and ``Trainer.restore_from`` reads.

    ``tree`` is the JAX ``SiDState`` (``step``, ``nimg``, ``params_G``,
    ``params_fake``, ``ema``, ``opt_G``, ``opt_fake``; the optax chains as
    orbax restores them without a template) or, with the pixel judge,
    ``{'state': ..., 'spectral': ...}``.  Parameters and Adam moments are
    carried by ``models.convert`` (a full-UNet or LoRA psi; the judge's
    heads under ``disc.``), each moment in its JAX dtype (bf16 for the
    low-memory state); the judge's ``u`` vectors become ``spectral``.  The
    dump has no step generator or iterator states: it says so in
    ``converted_from``."""
    from ..models.convert import disc_params_from_jax, lora_params_from_jax, unet_params_from_jax
    from ..training.distill import DISC_PREFIX

    tree = _np_tree(tree)
    spectral = tree.get("spectral") if "state" in tree else None
    st = tree["state"] if "state" in tree else tree

    def unet_like(part: Any) -> Dict[str, torch.Tensor]:
        if all("/" in k for k in part):
            sd = lora_params_from_jax(part, unet_cfg)
        else:
            sd = unet_params_from_jax(part, unet_cfg)
        dtypes = {str(a.dtype) for a in _leaves(part)}
        if dtypes == {"bfloat16"}:
            sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
        elif dtypes != {"float32"}:
            raise TypeError(f"parameters or moments in {sorted(dtypes)}; expected float32 or "
                            "bfloat16")
        return sd

    def params(part: Any) -> Optional[Dict[str, torch.Tensor]]:
        if part is None:
            return None
        if set(part) == {"psi", "disc"}:
            heads = disc_params_from_jax(part["disc"], None, None)
            return {**unet_like(part["psi"]), **{DISC_PREFIX + k: v for k, v in heads.items()}}
        return unet_like(part)

    def adam(opt: Any) -> dict:
        a = _adam_state(opt)
        if a is None:
            raise KeyError("no Adam state (count, mu, nu) in the optimizer state")
        return {"count": int(a["count"]), "mu": params(a.get("mu")), "nu": params(a["nu"])}

    state = {"step": int(st["step"]), "nimg": float(st["nimg"]),
             "params_G": params(st["params_G"]), "params_fake": params(st["params_fake"]),
             "ema": params(st["ema"]), "opt_G": adam(st["opt_G"]),
             "opt_fake": adam(st["opt_fake"])}
    out = {"state": state, "converted_from": JAX_ORIGIN}
    if spectral is not None:
        heads = st["params_fake"]["disc"]
        out["spectral"] = {k: v for k, v in disc_params_from_jax(heads, spectral, None).items()
                           if k.endswith(".u")}
    return out
