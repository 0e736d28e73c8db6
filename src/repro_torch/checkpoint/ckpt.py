"""Checkpoints in the JAX package's on-disk format, without JAX.

Layout:  <dir>/step_<N>/
           manifest.json        - keys, shapes, dtypes, crc32 checksums,
                                  metadata
           arrays.npz           - one entry per leaf, named by its key

A leaf's key is its path of dict keys, NamedTuple fields (as ``.name``,
as JAX prints a ``GetAttrKey``) and list or tuple indices joined by
``SEP``: ``index|backend|vectors``, ``1|.mu|embed|embedding`` for a
training checkpoint's ``(params, AdamWState)``. Dicts are walked in sorted
key order, ``None`` leaves are dropped, and leaves may be tensors (detached
and copied to the host), numpy arrays or Python scalars. bf16 and fp8 leaves are stored
as same-width unsigned views under their dtype's name (``"bfloat16"``,
``"float8_e4m3fn"``, ``"float8_e5m2"``) and come back by bit pattern, so a
checkpoint written here loads in ``repro.checkpoint.ckpt`` and the other
way round.

Writes are atomic (tmp dir + rename): the newest complete ``step_*``
directory is always loadable. ``load`` and ``restore`` read every array
eagerly and verify it against the manifest's key set and crc32 (a manifest
without ``checksums`` loads unverified); a failure is a
``CheckpointCorruptError``. With ``step=None`` they walk from the newest
step to the oldest and take the first intact one, warning for each corrupt
step skipped. Mirrors ``repro.checkpoint.ckpt``; ``device`` takes the place
of its ``shardings``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import struct
import tempfile
import warnings
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike

SEP = "|"

# dtypes npz cannot hold, stored as the same-width unsigned integers
_VIEW_DTYPES = {"bfloat16": (torch.bfloat16, np.uint16),
                "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
                "float8_e5m2": (torch.float8_e5m2, np.uint8)}
_TORCH_NAMES = {t: name for name, (t, _) in _VIEW_DTYPES.items()}

# what reading a torn, truncated or overwritten arrays.npz raises
_UNREADABLE = (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile,
               zlib.error, struct.error)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint step failed integrity verification (torn/truncated file,
    checksum mismatch, unreadable manifest, or missing arrays)."""


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree) -> list:
    """(key part, child) pairs of a dict, a NamedTuple or a list or tuple,
    keyed as JAX's tree paths print: a dict key as itself, a NamedTuple
    field as ``.name`` (``GetAttrKey``), an index as its number."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    return [(str(i), v) for i, v in enumerate(tree)]


def _walk(tree, path=()):
    """(key, leaf) pairs in the reference's flattening order: dicts by
    sorted key, NamedTuples by field, lists and tuples by index, ``None``
    dropped."""
    if tree is None:
        return
    if isinstance(tree, (dict, list, tuple)):
        children = _children(tree)
        if isinstance(tree, dict):
            children = sorted(children, key=lambda kv: kv[0])
        for k, v in children:
            yield from _walk(v, path + (k,))
    else:
        yield SEP.join(path), tree


def _rebuild(tree, fn, path=()):
    """``tree``'s structure with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, (dict, list, tuple)):
        out = [_rebuild(v, fn, path + (k,)) for k, v in _children(tree)]
        if isinstance(tree, dict):
            return dict(zip(tree, out))
        if _is_namedtuple(tree):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(SEP.join(path), tree)


def _to_storable(leaf) -> tuple:
    """(numpy array as stored, dtype name for the manifest); the caller
    makes it contiguous, which turns a 0-d leaf into shape (1,) in the npz,
    as in the reference (the manifest keeps the leaf's own shape)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _TORCH_NAMES:
            name = _TORCH_NAMES[t.dtype]
            store = np.dtype(_VIEW_DTYPES[name][1])
            signed = torch.int16 if store.itemsize == 2 else torch.int8
            return t.view(signed).numpy().view(store), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name in _VIEW_DTYPES:        # a numpy bf16/fp8 leaf (ml_dtypes)
        arr = arr.view(_VIEW_DTYPES[name][1])
    return arr, name


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A CPU tensor of the manifest's dtype from the stored array."""
    if dtype_name in _VIEW_DTYPES:
        t = torch.from_numpy(arr.view(np.int16 if arr.itemsize == 2
                                      else np.int8))
        return t.view(_VIEW_DTYPES[dtype_name][0])
    return torch.from_numpy(arr)


def _crc(arr: np.ndarray) -> int:
    """crc32 of the array's bytes, read in place."""
    return zlib.crc32(arr.reshape(-1).view(np.uint8))


def save(ckpt_dir: str, step: int, tree: Any, metadata: Optional[dict] = None,
         keep: int = 3) -> str:
    """Atomically write one checkpoint step; returns the step directory.

    ``tree``: nested dicts (or lists, tuples) of tensors, numpy arrays or
    scalars. ``metadata``: a JSON-serializable dict stored in the manifest.
    ``keep``: older step directories beyond this count are removed (0 keeps
    all). The write is tmp-dir + rename, and a failed write leaves no tmp
    dir behind."""
    os.makedirs(ckpt_dir, exist_ok=True)
    stored, names, shapes = {}, {}, {}
    for key, leaf in _walk(tree):
        arr, names[key] = _to_storable(leaf)
        shapes[key] = list(arr.shape)
        stored[key] = np.ascontiguousarray(arr)
    manifest = {
        "step": step,
        "treedef": f"nested dicts of {len(stored)} leaves",
        "keys": sorted(stored),
        "shapes": shapes,
        "dtypes": names,
        "checksums": {k: _crc(v) for k, v in stored.items()},
        "metadata": metadata or {},
    }
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **stored)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list:
    """The steps with a manifest under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read_step(step_dir: str) -> tuple:
    """Read and verify one step directory: (manifest, {key: array}).

    Every array is read eagerly, so truncation and zip damage surface here,
    and checked against the manifest's crc32 when it has ``checksums``. Any
    failure raises ``CheckpointCorruptError``."""
    try:
        with open(os.path.join(step_dir, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"{step_dir}: unreadable manifest ({e})") from e
    data = {}
    try:
        with np.load(os.path.join(step_dir, "arrays.npz")) as npz:
            present = set(npz.files)
            for key in manifest["keys"]:
                if key in present:
                    data[key] = np.ascontiguousarray(npz[key])
    except _UNREADABLE as e:
        raise CheckpointCorruptError(
            f"{step_dir}: unreadable arrays.npz ({e})") from e
    for key in manifest["keys"]:
        if key not in data:
            raise CheckpointCorruptError(
                f"{step_dir}: array {key!r} missing from arrays.npz")
    checksums = manifest.get("checksums")
    if checksums is not None:
        for key, arr in data.items():
            want, got = checksums.get(key), _crc(arr)
            if want != got:
                raise CheckpointCorruptError(
                    f"{step_dir}: checksum mismatch for {key!r} "
                    f"(manifest {want}, file {got})")
    return manifest, data


def _read_verified(ckpt_dir: str, step: Optional[int]) -> tuple:
    """Resolve ``step`` and read it verified; ``step=None`` walks newest to
    oldest to the first intact step, warning for each corrupt one. Returns
    (manifest, data, step)."""
    if step is not None:
        manifest, data = _read_step(os.path.join(ckpt_dir,
                                                 f"step_{step:08d}"))
        return manifest, data, step
    steps = all_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    last_err = None
    for s in reversed(steps):
        try:
            manifest, data = _read_step(os.path.join(ckpt_dir,
                                                     f"step_{s:08d}"))
            return manifest, data, s
        except CheckpointCorruptError as e:
            warnings.warn(f"skipping corrupt checkpoint step {s}: {e}")
            last_err = e
    raise CheckpointCorruptError(
        f"{ckpt_dir}: every checkpoint step is corrupt "
        f"(newest error: {last_err})")


def _leaf(manifest: dict, data: dict, key: str) -> torch.Tensor:
    """One stored leaf as a CPU tensor of its manifest dtype and shape (a
    0-d leaf is stored as (1,); the reference hands that back as it is)."""
    t = _from_storable(data[key], manifest["dtypes"][key])
    shape = manifest.get("shapes", {}).get(key)
    return t if shape is None else t.reshape(shape)


def load(ckpt_dir: str, step: Optional[int] = None) -> tuple:
    """Template-free restore: the nested-dict tree rebuilt from the
    manifest's keys, as CPU tensors in the manifest's dtypes (bf16 and fp8
    by bit pattern), which ``fcvi.index_from_state`` takes as it is.
    Verified first; with ``step=None`` a corrupt newest step falls back to
    the newest intact one. Returns (tree, step, metadata)."""
    manifest, data, step = _read_verified(ckpt_dir, step)
    tree: dict = {}
    for key in manifest["keys"]:
        node = tree
        parts = key.split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _leaf(manifest, data, key)
    return tree, step, manifest["metadata"]


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    name = str(np.asarray(leaf).dtype)
    if name in _VIEW_DTYPES:
        return _VIEW_DTYPES[name][0]
    return torch.from_numpy(np.zeros(0, np.asarray(leaf).dtype)).dtype


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None,
            device: Optional[DeviceLike] = None) -> tuple:
    """Restore into ``template``'s structure: the key sets must match, each
    leaf's shape must equal the template leaf's, and each comes back as a
    tensor cast to the template leaf's dtype, on ``device`` (None: the
    template leaf's device where it is a tensor, else the CPU). Verified
    like ``load``. Returns (tree, step, metadata)."""
    manifest, data, step = _read_verified(ckpt_dir, step)
    keys = sorted(k for k, _ in _walk(template))
    if keys != manifest["keys"]:
        diff = set(manifest["keys"]) ^ set(keys)
        raise ValueError(
            f"checkpoint/template key mismatch: {sorted(diff)[:8]}")

    def leaf(key, tmpl):
        t = _leaf(manifest, data, key)
        shape = tuple(tmpl.shape) if isinstance(tmpl, torch.Tensor) \
            else np.shape(tmpl)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"template {tuple(shape)}")
        dev = device
        if dev is None:
            dev = tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
        return t.to(device=dev, dtype=_torch_dtype(tmpl))

    return _rebuild(template, leaf), step, manifest["metadata"]
