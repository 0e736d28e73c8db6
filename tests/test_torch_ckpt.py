"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) against the JAX
package's (``repro.checkpoint.ckpt``): one on-disk format, written and read
by either.

* The same tree (and the same index state, for every backend and storage
  dtype) gives manifests with equal ``keys``, ``shapes``, ``dtypes`` and
  ``checksums`` in both packages, so the stored arrays are the same bytes.
* A JAX-written checkpoint loads in the port and a port-written one in the
  JAX package; bf16 leaves are compared by bit pattern both ways.
* The lifecycle: GC and ``latest_step``, the shape and key checks, a
  corrupt newest step falling back with a warning, an explicit corrupt step
  raising, every step corrupt raising, a manifest without checksums
  loading, and a failed save leaving no tmp dir.
"""
import json
import os
import zlib

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.checkpoint import ckpt as jckpt
from repro.core import fcvi as jfcvi
from repro_torch.checkpoint import ckpt
from repro_torch.core import fcvi
from test_torch_support import to_numpy_tree


def _bf16_bits(x) -> np.ndarray:
    """The 16-bit patterns of a bf16 torch tensor or ml_dtypes array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _trees():
    """(port tree, JAX tree) of the same values: fp32, int32, uint8, bf16
    (with a NaN, -0.0 and a subnormal), fp64 and a 0-d leaf, lists, nested
    dicts and a dropped None."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 5)).astype(np.float32)
    ids = rng.integers(-9, 9, (7,)).astype(np.int32)
    codes = rng.integers(0, 256, (4, 8)).astype(np.uint8)
    bf = rng.normal(size=(6,)).astype(ml_dtypes.bfloat16)
    bf[1], bf[2], bf[3] = np.nan, -0.0, 1e-40
    f64 = rng.normal(size=(2,))
    port = {"a": torch.tensor(a), "z": {"ids": torch.tensor(ids),
                                        "codes": torch.tensor(codes)},
            "list": [torch.tensor(bf.view(np.int16)).view(torch.bfloat16),
                     {"f64": torch.tensor(f64), "none": None}],
            "alpha": torch.tensor(1.5, dtype=torch.float32)}
    jax_tree = {"a": jnp.asarray(a), "z": {"ids": jnp.asarray(ids),
                                           "codes": jnp.asarray(codes)},
                "list": [jnp.asarray(bf), {"f64": f64, "none": None}],
                "alpha": jnp.asarray(1.5, jnp.float32)}
    return port, jax_tree


def _manifest(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return json.load(f)


def _same_manifest(a, b):
    for field in ("keys", "shapes", "dtypes", "checksums"):
        assert a[field] == b[field], field


def test_same_tree_same_manifest(tmp_path):
    port, jax_tree = _trees()
    mine = _manifest(ckpt.save(str(tmp_path / "port"), 3, port,
                               metadata={"x": 1}))
    theirs = _manifest(jckpt.save(str(tmp_path / "jax"), 3, jax_tree,
                                  metadata={"x": 1}))
    _same_manifest(mine, theirs)
    assert mine["keys"] == ["a", "alpha", "list|0", "list|1|f64", "z|codes",
                            "z|ids"]
    assert mine["dtypes"]["list|0"] == "bfloat16"
    assert mine["dtypes"]["alpha"] == "float32"
    assert mine["step"] == 3 and mine["metadata"] == {"x": 1}


INDEX_CONFIGS = {
    "flat": dict(),
    "flat-bf16": dict(storage_dtype="bfloat16"),
    "flat-int8": dict(storage_dtype="int8"),
    "cluster": dict(mode="cluster", n_clusters=4),
    "embedding": dict(mode="embedding"),
    "ivf-int8": dict(backend="ivf", nlist=8, nprobe=3, storage_dtype="int8"),
    "ivf-bf16": dict(backend="ivf", nlist=8, nprobe=3,
                     storage_dtype="bfloat16"),
    "pq": dict(backend="pq", pq_m=4, pq_ksub=16, pq_coarse=4),
}


@pytest.mark.parametrize("name", sorted(INDEX_CONFIGS))
def test_index_state_manifests_agree_leaf_by_leaf(tmp_path, name):
    """The JAX index's state and the port's state of the same index (handed
    across) store the same leaves: keys, shapes, dtypes and bytes. The 0-d
    ``alpha`` is float32 in both (the JAX transform holds it as a float32
    array, the port's ``index_state`` as a float32 tensor)."""
    rng = np.random.default_rng(1)
    v = rng.normal(size=(600, 16)).astype(np.float32)
    f = rng.normal(size=(600, 4)).astype(np.float32)
    cfg = INDEX_CONFIGS[name]
    jidx = jfcvi.build(jnp.asarray(v), jnp.asarray(f),
                       jfcvi.FCVIConfig(**cfg))
    mine = fcvi.index_from_state(fcvi.FCVIConfig(**cfg),
                                 to_numpy_tree(jfcvi.index_state(jidx)),
                                 device="cpu")
    a = _manifest(ckpt.save(str(tmp_path / "port"), 0,
                            fcvi.index_state(mine)))
    b = _manifest(jckpt.save(str(tmp_path / "jax"), 0,
                             jfcvi.index_state(jidx)))
    _same_manifest(a, b)
    assert a["dtypes"]["transform|alpha"] == "float32"
    assert a["shapes"]["transform|alpha"] == []


def test_jax_written_loads_in_the_port(tmp_path):
    port, jax_tree = _trees()
    jckpt.save(str(tmp_path), 5, jax_tree, metadata={"cfg": {"k": 3}})
    tree, step, meta = ckpt.load(str(tmp_path))
    assert step == 5 and meta == {"cfg": {"k": 3}}
    assert tree["list"]["0"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(tree["list"]["0"]),
                                  _bf16_bits(jax_tree["list"][0]))
    np.testing.assert_array_equal(tree["a"].numpy(), port["a"].numpy())
    assert tree["z"]["codes"].dtype == torch.uint8
    assert tree["z"]["ids"].dtype == torch.int32
    assert tree["list"]["1"]["f64"].dtype == torch.float64
    assert tree["alpha"].shape == () and float(tree["alpha"]) == 1.5
    # restore into a template of the port's structure: dtypes and nesting
    out, _, _ = ckpt.restore(str(tmp_path), port)
    assert isinstance(out["list"], list) and out["list"][1]["none"] is None
    np.testing.assert_array_equal(_bf16_bits(out["list"][0]),
                                  _bf16_bits(jax_tree["list"][0]))
    np.testing.assert_array_equal(out["z"]["ids"].numpy(),
                                  port["z"]["ids"].numpy())


def test_port_written_loads_in_jax(tmp_path):
    """The JAX ``load`` hands a 0-d leaf back at its stored shape (1,), and
    its ``restore`` then refuses a 0-d template leaf (its own checkpoints
    too), so the restore half runs without the 0-d leaf."""
    port, jax_tree = _trees()
    ckpt.save(str(tmp_path), 2, port, metadata={"m": [1, 2]})
    tree, step, meta = jckpt.load(str(tmp_path))
    assert step == 2 and meta == {"m": [1, 2]}
    assert tree["alpha"].shape == (1,) and tree["alpha"][0] == 1.5
    del port["alpha"], jax_tree["alpha"]
    ckpt.save(str(tmp_path), 3, port)
    assert tree["list"]["0"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(_bf16_bits(tree["list"]["0"]),
                                  _bf16_bits(port["list"][0]))
    np.testing.assert_array_equal(tree["z"]["codes"],
                                  port["z"]["codes"].numpy())
    out, _, _ = jckpt.restore(str(tmp_path), jax_tree)
    np.testing.assert_array_equal(_bf16_bits(out["list"][0]),
                                  _bf16_bits(jax_tree["list"][0]))


def test_fp8_leaves_round_trip_by_bit_pattern(tmp_path):
    bits = torch.arange(256, dtype=torch.int16).to(torch.uint8)
    tree = {"e4": bits.view(torch.float8_e4m3fn),
            "e5": bits.view(torch.float8_e5m2)}
    man = _manifest(ckpt.save(str(tmp_path), 0, tree))
    assert man["dtypes"] == {"e4": "float8_e4m3fn", "e5": "float8_e5m2"}
    out, _, _ = ckpt.load(str(tmp_path))
    for key, dtype in (("e4", torch.float8_e4m3fn), ("e5", torch.float8_e5m2)):
        assert out[key].dtype == dtype
        assert torch.equal(out[key].view(torch.uint8), bits)
    jtree, _, _ = jckpt.load(str(tmp_path))
    assert jtree["e5"].dtype == ml_dtypes.float8_e5m2
    np.testing.assert_array_equal(np.asarray(jtree["e4"]).view(np.uint8),
                                  bits.numpy())


def test_checksums_are_crc32_of_the_stored_bytes(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32),
            "b": torch.ones(3, dtype=torch.bfloat16)}
    man = _manifest(ckpt.save(str(tmp_path), 1, tree))
    assert man["checksums"]["a"] == zlib.crc32(
        np.arange(6, dtype=np.float32).tobytes())
    assert man["checksums"]["b"] == zlib.crc32(
        np.full(3, 0x3F80, np.uint16).tobytes())


def test_gc_and_latest_step(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, {"x": torch.ones(2)}, keep=3)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    ckpt.save(str(tmp_path), 9, {"x": torch.ones(2)}, keep=0)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4, 5, 9]
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.load(str(tmp_path / "none"))


def test_restore_checks_shapes_and_keys_and_casts(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"x": torch.ones(5)})
    with pytest.raises(ValueError, match="key mismatch"):
        ckpt.restore(str(tmp_path), {"y": torch.ones(4)})
    out, step, _ = ckpt.restore(str(tmp_path),
                                {"x": np.zeros(4, np.float64)})
    assert step == 1 and out["x"].dtype == torch.float64
    assert out["x"].device.type == "cpu"


def _tear(path):
    path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])


def test_corrupt_newest_falls_back_with_a_warning(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(4)})
    ckpt.save(str(tmp_path), 2, {"a": torch.full((4,), 2.0)})
    _tear(tmp_path / "step_00000002" / "arrays.npz")
    with pytest.warns(UserWarning, match="skipping corrupt"):
        out, step, _ = ckpt.load(str(tmp_path))
    assert step == 1 and torch.equal(out["a"], torch.ones(4))
    with pytest.warns(UserWarning, match="skipping corrupt"):
        out, step, _ = ckpt.restore(str(tmp_path), {"a": torch.zeros(4)})
    assert step == 1


@pytest.mark.parametrize("damage", ["manifest", "torn", "garbage",
                                    "checksum", "missing"])
def test_explicit_corrupt_step_raises(tmp_path, damage):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(4), "b": torch.zeros(2)})
    step_dir = tmp_path / "step_00000001"
    npz, mpath = step_dir / "arrays.npz", step_dir / "manifest.json"
    manifest = json.loads(mpath.read_text())
    if damage == "manifest":
        mpath.write_text("{ not json")
    elif damage == "torn":
        _tear(npz)
    elif damage == "garbage":
        npz.write_bytes(b"\x00" * 64)
    elif damage == "checksum":
        manifest["checksums"]["a"] ^= 1
        mpath.write_text(json.dumps(manifest))
    else:
        manifest["keys"].append("c")
        mpath.write_text(json.dumps(manifest))
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load(str(tmp_path), step=1)


def test_every_step_corrupt_raises(tmp_path):
    for s in (1, 2):
        ckpt.save(str(tmp_path), s, {"a": torch.ones(4)})
        _tear(tmp_path / f"step_{s:08d}" / "arrays.npz")
    with pytest.warns(UserWarning), \
            pytest.raises(ckpt.CheckpointCorruptError, match="every"):
        ckpt.load(str(tmp_path))


def test_manifest_without_checksums_loads(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.arange(4, dtype=torch.float32)})
    mpath = tmp_path / "step_00000001" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    del manifest["checksums"]
    mpath.write_text(json.dumps(manifest))
    out, step, _ = ckpt.load(str(tmp_path))
    assert step == 1
    assert torch.equal(out["a"], torch.arange(4, dtype=torch.float32))


def test_failed_save_leaves_no_tmp_dir(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(2)})
    with pytest.raises(TypeError):   # not JSON-serializable metadata
        ckpt.save(str(tmp_path), 2, {"a": torch.ones(2)},
                  metadata={"bad": object()})
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]
    assert ckpt.all_steps(str(tmp_path)) == [1]
