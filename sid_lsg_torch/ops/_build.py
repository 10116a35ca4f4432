"""Build, load and dispatch to the port's CUDA kernels.

``csrc/*.cu`` (with the headers ``csrc/*.cuh``) compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``.  The sources compile in
parallel, one ``nvcc`` each, and link into
``sid_lsg_torch/_build/<hash>/libsidlsg_kernels.so``, where the hash covers
the sources and the flags, so an edited source builds anew and an unchanged
one loads at once.  A failed build raises; nothing falls back to the plain
PyTorch versions.  ``use_kernel`` is the one place that picks a path: the
kernel for CUDA tensors, the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libsidlsg_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: each kernel's registers, shared memory and spills go to build.log.
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "sidlsg_flash_attn_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "sidlsg_gn_stats_clustered": [_P, _P, _P, _I, _L, _I, _F, _I, _P],
    "sidlsg_gn_fused": [_P, _P, _P, _P, _I, _I, _I, _L, _I, _F, _I, _I, _P],
    "sidlsg_gn_apply": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _P],
    "sidlsg_flash_attn_bwd": [_P] * 11 + [_I, _I, _I, _I, _F, _I, _P],
    "sidlsg_flash_attn_bwd_dq": [_P] * 8 + [_I, _I, _I, _I, _F, _I, _P],
    "sidlsg_flash_attn_bwd_dkv": [_P] * 9 + [_I, _I, _I, _I, _F, _I, _P],
    "sidlsg_flash_attn_bwd_twopass": [_P] * 10 + [_I, _I, _I, _I, _F, _I, _P],
    "sidlsg_bias_act": [_P, _P, _P, _L, _I, _L, _I, _F, _F, _F, _I, _P],
    "sidlsg_flash_attn_fwd_smem": [_I, _I],
    "sidlsg_flash_attn_bwd_smem": [_I, _I],
    "sidlsg_flash_attn_bwd_dkv_smem": [_I, _I],
    "sidlsg_flash_attn_bwd_dq_smem": [_I, _I],
}

_lib: Optional[ctypes.CDLL] = None


def sources(csrc: Path = CSRC) -> list:
    return sorted(csrc.glob("*.cu"))


def source_key(csrc: Path = CSRC) -> str:
    """Hash of the kernel sources, their headers and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(csrc) + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                           "the CUDA kernels cannot be built")
    return nvcc


def build(csrc: Path = CSRC) -> Path:
    """Compile the kernels of ``csrc`` if this source hash has no library yet;
    return its path."""
    out_dir = BUILD_ROOT / source_key(csrc)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building the same hash
        if lib_path.exists():
            return lib_path
        srcs = sources(csrc)
        objs = [out_dir / (src.stem + ".o") for src in srcs]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{src.name}:\n{log}" for src, p, log in zip(srcs, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        tmp = out_dir / (LIB_NAME + ".tmp")
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out_dir / "build.log").write_text("\n".join(logs) + link.stdout)
        os.replace(tmp, lib_path)
    return lib_path


def load(lib_path: Path, required: bool = True) -> ctypes.CDLL:
    """Load a kernel library and declare its C entries; with ``required``
    False, entries the library lacks (an older checkout's) are skipped."""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        if not required and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sidlsg_error_string.argtypes = [ctypes.c_int]
    lib.sidlsg_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def ptxas_report(lib_path: Path) -> list:
    """(kernel, registers, spill stores, spill loads) per compiled kernel,
    from the ``-Xptxas -v`` lines of the build log beside ``lib_path``.
    Mangled names are kept; ``c++filt`` demangles them."""
    rows, name, spill = [], None, (0, 0)
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1))) + spill)
            name = None
    return rows


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = library().sidlsg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def use_kernel(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version); raise for any other device or a mix of devices."""
    first = tensors[0]
    if first.is_cuda:  # the common case on the card, without building device objects
        index = first.get_device()
        if all(t.is_cuda and t.get_device() == index for t in tensors[1:]):
            return True
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind == "cpu":
        return False
    if kind == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device type {kind!r}")


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {t.dtype}")
    return code
