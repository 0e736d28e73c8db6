"""Build, bind and count the port's CUDA kernels.

The sources under ``repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` at first use, one ``nvcc -c`` per source, all started together,
then linked into one shared library with a plain C interface that ``ctypes``
loads. The library lives in ``build/repro_torch/<hash of sources and
flags>/`` at the root of the checkout (listed in ``.gitignore``), so a
changed source builds anew and an unchanged one is loaded as it is. A file
lock makes concurrent first users (test workers) build once. A failed build
raises; nothing falls back to the plain versions.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
``check`` raises on a non-zero code. ``count`` is the per-wrapper launch
counter that shows a run went through the kernels.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
LIB_NAME = "libfcvi_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
SIGNATURES = {
    "fcvi_fused_transform": [_P, _P, _P, _F, _P, _P, _P, _P, _P, _L, _I, _I,
                             _P],
    "fcvi_score_topk": [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _L, _I, _P,
                        _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "fcvi_rescore": [_P, _P, _P, _P, _F, _F, _P, _I, _I, _I, _I, _P],
    "fcvi_ivf_score_topk": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                            _P, _P],
}

_lock = threading.Lock()
_lib = None
_launches: dict = {}


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "cannot be built")
    return str(path)


def build() -> Path:
    """Compile and link the kernels if this source hash has no library yet.
    Returns the library's path; raises RuntimeError on a failed build."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        nvcc = _nvcc()
        objs = [out / (src.stem + ".o") for src in sources()]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objs)]
        # wait for every compiler before reporting a failure, so none is
        # left running
        logs = [f"== {src.name}\n{proc.communicate()[0]}"
                for src, proc in zip(sources(), procs)]
        failed = [log for log, proc in zip(logs, procs) if proc.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = out / (LIB_NAME + ".tmp")
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out / "ptxas.log").write_text("".join(logs))
        os.replace(tmp, lib)
    return lib


def build_log() -> str:
    """What ``-Xptxas -v`` reported for the current sources (registers,
    shared memory, spills), as saved by the build."""
    path = build_dir() / "ptxas.log"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.fcvi_error_string.argtypes = [ctypes.c_int]
            lib.fcvi_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    if code:
        msg = library().fcvi_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t):
    """Device address of ``t``, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, shape: tuple,
            device: torch.device, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (the only layout the kernels take)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def count(name: str) -> None:
    """Add one launch of kernel ``name``."""
    _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()
