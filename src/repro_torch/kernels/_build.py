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
import dataclasses
import fcntl
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

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
    "fcvi_score_topk": [_P, _I, _P, _P, _P, _P, _I, _P, _I, _P, _L, _I, _I,
                        _I, _I, _I, _I, _I, _I, _L, _P, _P, _P, _P, _P, _L,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                        _P, _P, _P],
    "fcvi_select_topk": [_P, _L, _P, _P, _P, _P],
    "fcvi_rescore": [_P, _P, _P, _P, _F, _F, _P, _I, _I, _I, _I, _P],
    "fcvi_rescore_topk": [_P, _P, _P, _P, _F, _F, _P, _I, _I, _I, _I, _I, _I,
                          _L, _P, _P, _P],
    "fcvi_ivf_score_topk": [_P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "fcvi_ivf_masked_slots": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                              _P],
    "fcvi_pq_scan_luts": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _P],
    "fcvi_pq_score": [_P, _I, _P, _P, _P, _L, _I, _I, _I, _L, _I, _P, _P],
    "fcvi_pq_score_topk": [_P, _P, _P],
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
    """The loaded kernel library (built on first call; once loaded, no
    lock is taken)."""
    global _lib
    if _lib is not None:
        return _lib
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


def addr(args):
    """Host address of a ctypes structure (``SelectArgs``), or None."""
    return None if args is None else ctypes.addressof(args)


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


# the stored element types the scan kernels take, by their code in the C
# entry points (kF32, kBF16, kI8 in csrc/topk_common.cuh), and the suffix of
# each variant's launch counter
ELEMENT_TYPES = {torch.float32: (0, ""), torch.bfloat16: (1, "_bf16"),
                 torch.int8: (2, "_int8")}


def element_type(t: torch.Tensor, name: str):
    """(code, counter suffix) of the scanned rows' dtype; raises for a dtype
    the scan kernels do not take (nothing is cast quietly)."""
    if t.dtype not in ELEMENT_TYPES:
        raise ValueError(f"{name} must be float32, bfloat16 or int8, got "
                         f"{t.dtype}")
    return ELEMENT_TYPES[t.dtype]


# The selection path of the scans (csrc/select_common.cuh): pass blocks over
# (query, chunk) histogram 16-bit digits of the packed words (16-bit
# counters: a chunk holds at most SELECT_MAX_CHUNK entries) and compact the
# candidates into a buffer of `cap` words a query; one block per query then
# selects among them and sorts a power of two >= kk words (8 bytes, plus a
# 4-byte entry index) in shared memory up to SORT_SMEM_LIMIT bytes, else in
# device scratch.
SELECT_BINS = 1 << 16          # kBins
SELECT_HIST_WORDS = SELECT_BINS + 256   # kHistWords: bins and coarse sums
SELECT_MAX_CHUNK = 65535       # kMaxChunk
SELECT_MIN_CHUNK = 16384       # the fewest entries a pass block is given
SELECT_MIN_CAP = 16384         # the smallest candidate buffer (words)
SELECT_PASSES = 5              # kSelPasses: four digits and a compaction
SELECT_STATS = 3 * (SELECT_PASSES + 1)   # kSelStatSlots
SELECT_STATE = 64              # sizeof(SelQuery)
SORT_SMEM_LIMIT = 196_608


@dataclasses.dataclass(frozen=True)
class SelectPlan:
    chunk: int        # entries a pass block reads (whole segments if it can)
    nchunks: int      # pass blocks a query
    cap: int          # candidate-buffer words a query
    sort_len: int     # the finish's sort: a power of two >= kk
    sort_in_smem: bool
    hist: bool        # histogram passes run (more entries than the buffer)
    passes: int       # pass launches


def select_plan(nq: int, n: int, kk: int, num_sms: int,
                seg_len: Optional[int] = None,
                cap: Optional[int] = None) -> SelectPlan:
    """The select's launch shape for ``nq`` queries of at most ``n``
    entries each (the flat scan's rows, the IVF scans' ``nseg * seg_len``
    slots, the PQ rows) and any kk >= 1. The buffer holds twice kk and at
    least SELECT_MIN_CAP words (a power of two), or every entry where there
    are fewer: then no histogram runs. A chunk is at most SELECT_MAX_CHUNK
    entries, a run of whole segments where a segment fits (IVF), and small
    enough that the (query, chunk) grid covers the SMs twice, down to
    SELECT_MIN_CHUNK entries (or one segment) a chunk. ``cap`` (at least
    min(kk, n)) sets the buffer instead, so a test or a profile can force
    the histogram passes over the full row."""
    if kk <= 0 or n < 0 or nq <= 0:
        raise ValueError(f"select of k={kk} over {nq} x {n} entries")
    if n >= 2 ** 31:
        raise ValueError("entry indices must fit in int32")
    if cap is None:
        cap = 1 << max(2 * kk - 1, SELECT_MIN_CAP - 1).bit_length()
    elif cap < min(kk, n):
        raise ValueError(f"a buffer of {cap} words cannot hold k={kk}")
    cap = max(1, min(n, cap))
    hist = n > cap
    want = math.ceil(2 * num_sms / nq)        # chunks that fill the card twice
    if seg_len is not None and seg_len <= SELECT_MAX_CHUNK:
        segs = max(1, min(SELECT_MAX_CHUNK // seg_len,
                          n // seg_len // want))
        chunk = segs * seg_len
    else:
        chunk = min(SELECT_MAX_CHUNK, max(SELECT_MIN_CHUNK, n // want))
    nchunks = max(1, math.ceil(n / chunk))
    if nchunks > 65535:
        raise ValueError(f"{nchunks} chunks past the grid's 65535")
    sort_len = 1 << (kk - 1).bit_length()
    return SelectPlan(chunk=chunk, nchunks=nchunks, cap=cap,
                      sort_len=sort_len,
                      sort_in_smem=12 * sort_len <= SORT_SMEM_LIMIT,
                      hist=hist, passes=SELECT_PASSES if hist else 1)


def _aligned(nbytes: int) -> int:
    return -(-nbytes // 256) * 256


def select_scratch_bytes(p: SelectPlan, nq: int) -> dict:
    """Bytes of each part of the select's device scratch: the queries'
    states, the histograms (when they run), the candidate buffer (words and
    entry indices) and the sort's scratch past shared memory."""
    return {"state": _aligned(SELECT_STATE * nq),
            "hist": _aligned(4 * SELECT_HIST_WORDS * nq) if p.hist else 0,
            "bufw": _aligned(8 * p.cap * nq),
            "bufp": _aligned(4 * p.cap * nq),
            "sort_w": 0 if p.sort_in_smem else _aligned(8 * p.sort_len * nq),
            "sort_pos": (0 if p.sort_in_smem
                         else _aligned(4 * p.sort_len * nq))}


class SelectArgs(ctypes.Structure):
    """csrc/select_common.cuh's SelectArgs: the same fields in order."""
    _fields_ = [("st", _P), ("hist", _P), ("bufw", _P), ("bufp", _P),
                ("sort_w", _P), ("sort_pos", _P), ("stats", _P),
                ("chunk", _L), ("nchunks", _I), ("cap", _I), ("len", _I),
                ("passes", _I), ("kk", _I), ("nq", _I)]


def select_args(p: SelectPlan, nq: int, kk: int, device: torch.device,
                stats: Optional[torch.Tensor] = None):
    """(SelectArgs for the C entry points, passed by ``ctypes.addressof``,
    and the scratch tensor that backs it; keep both alive until the launch
    is enqueued). ``stats``, an int64
    tensor of SELECT_STATS entries on the card (the first of each three
    at -1, the rest 0), takes the passes' and the finish's spans."""
    parts = select_scratch_bytes(p, nq)
    scratch = torch.empty(sum(parts.values()), dtype=torch.uint8,
                          device=device)
    base, at, ptrs = scratch.data_ptr(), 0, {}
    for name, nbytes in parts.items():
        ptrs[name] = base + at if nbytes else None
        at += nbytes
    args = SelectArgs(ptrs["state"], ptrs["hist"], ptrs["bufw"],
                      ptrs["bufp"], ptrs["sort_w"], ptrs["sort_pos"],
                      ptr(stats), p.chunk, p.nchunks, p.cap, p.sort_len,
                      p.passes, kk, nq)
    return args, scratch


def select_stats(device: torch.device) -> torch.Tensor:
    """A zeroed profile for ``select_args``: each launch's first start at
    the largest value, so the kernels' atomic minimum takes the first."""
    stats = torch.zeros(SELECT_STATS, dtype=torch.int64, device=device)
    stats[0::3] = -1
    return stats


SELECT_NAME = "select"   # the select's counter, wherever its kernels run


def count(name: str) -> None:
    """Add one launch of kernel ``name``."""
    _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()
