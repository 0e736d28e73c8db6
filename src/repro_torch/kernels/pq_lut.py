"""CUDA kernels B8/B9/B10: PQ LUT cross term and ADC scans.

One CUDA source (``csrc/pq_lut.cu``) replaces the three Pallas kernels of
``repro/kernels/pq_lut.py``:

* ``pq_lut_qdot`` (B8): (b, M, dsub) x (M, ksub, dsub) -> (b, M, ksub), the
  q . codebook cross term of ``index.pq.compute_luts``;
* ``pq_score_batch`` (B9): codes (n, M) uint8 or int32, luts (b, M, K) ->
  squared distances (b, n), each a left-to-right fp32 sum over m;
* ``pq_score`` (B10): the same at one LUT, (M, K) -> (n,); B9's kernel
  launched at b = 1, counted under its own name.

The wrappers take unpadded shapes (the JAX ``pq_score`` needs n to divide
its row block; these do not), check operands, launch on the current stream
and count launches in ``_build``. Codes must lie in [0, K): the kernel
reads the LUT at them unchecked, as the TPU kernel's one-hot does not fault
either. The plain versions are ``ref.ref_pq_*``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME_QDOT = "pq_lut_qdot"
NAME_BATCH = "pq_score_batch"
NAME_SCORE = "pq_score"

Q_TILE = 8            # queries per pq_lut_qdot block (kQTile in the source)
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper (bytes)
ROW_TILE = 256        # rows per pq_score block (kRowTile)
CODE_BYTES = {torch.uint8: 1, torch.int32: 4}


def qdot_smem(ksub: int, dsub: int) -> int:
    """pq_lut_qdot's dynamic shared memory in bytes (the source's)."""
    return 4 * (ksub * (dsub | 1) + Q_TILE * dsub)


def pq_lut_qdot(queries_sub: torch.Tensor,
                codebooks: torch.Tensor) -> torch.Tensor:
    """queries_sub (b, M, dsub), codebooks (M, ksub, dsub), float32 on one
    CUDA device. Returns (b, M, ksub) float32."""
    if queries_sub.dim() != 3 or codebooks.dim() != 3:
        raise ValueError("queries_sub and codebooks must be 3-D")
    b, m, dsub = queries_sub.shape
    ksub = codebooks.shape[1]
    dev = queries_sub.device
    _build.require(queries_sub, "queries_sub", (b, m, dsub), dev)
    _build.require(codebooks, "codebooks", (m, ksub, dsub), dev)
    if qdot_smem(ksub, dsub) > SMEM_LIMIT:
        raise ValueError(f"a ({ksub}, {dsub}) codebook does not fit in "
                         "shared memory")
    out = torch.empty((b, m, ksub), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.fcvi_pq_lut_qdot(queries_sub.data_ptr(),
                                    codebooks.data_ptr(), out.data_ptr(), b,
                                    m, ksub, dsub, _build.stream(dev))
    _build.check(code, NAME_QDOT)
    _build.count(NAME_QDOT)
    return out


def _score(codes: torch.Tensor, luts: torch.Tensor, name: str):
    if codes.dim() != 2 or luts.dim() != 3:
        raise ValueError("codes must be 2-D and luts 3-D")
    n, m = codes.shape
    b, _, k = luts.shape
    dev = codes.device
    if codes.dtype not in CODE_BYTES:
        raise ValueError(f"codes must be uint8 or int32, got {codes.dtype}")
    _build.require(codes, "codes", (n, m), dev, codes.dtype)
    _build.require(luts, "luts", (b, m, k), dev)
    if 4 * m * ROW_TILE > SMEM_LIMIT:
        raise ValueError(f"M={m} codes per row do not fit in shared memory")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.fcvi_pq_score(codes.data_ptr(), CODE_BYTES[codes.dtype],
                                 luts.data_ptr(), out.data_ptr(), n, b, m, k,
                                 _build.stream(dev))
    _build.check(code, name)
    _build.count(name)
    return out


def pq_score_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes (n, M) uint8 or int32 in [0, K), luts (b, M, K) float32, on one
    CUDA device. Returns squared distances (b, n) float32."""
    return _score(codes, luts, NAME_BATCH)


def pq_score(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes (n, M) uint8 or int32 in [0, K), lut (M, K) float32. Returns
    squared distances (n,) float32."""
    if lut.dim() != 2:
        raise ValueError("lut must be 2-D (M, K)")
    return _score(codes, lut[None], NAME_SCORE)[0]
