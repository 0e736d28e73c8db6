"""Device meshes for sharded serving.

The port's counterpart of a ``jax.sharding.Mesh``: named axes, a shape, and
one ``torch.device`` per mesh position (``ShardMesh``). The sharded serving
step (``repro_torch.serve.sharded``) places one shard on each position
along the axes its ``AxisRules`` entry names, in its own tensors on that
position's device, and runs the shards from one process. On a machine with
one card every position is ``cuda:0``: the shards are logical. With
several cards ``make_mesh`` deals the positions out over them, so the same
code places a shard on each. A mesh of ``"cpu"`` positions runs the plain
PyTorch versions; the caller asks for it, as the tests do. Mirrors
``repro.launch.mesh``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class ShardMesh:
    """Named mesh axes over an array of devices: ``devices`` is a numpy
    object array of ``torch.device`` whose shape is the mesh's."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{len(self.axis_names)} axis names for a mesh of shape "
                f"{self.devices.shape}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis names {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> extent, in axis order (``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_at(self, coords: Dict[str, int]) -> torch.device:
        """The device at the position with ``coords`` along the named axes
        and 0 along the others."""
        idx = tuple(coords.get(a, 0) for a in self.axis_names)
        return self.devices[idx]


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: DeviceLike = "cuda") -> ShardMesh:
    """A mesh of ``shape`` with axis names ``axes``. ``device="cuda"`` (no
    index) deals the positions out over the visible cards in row-major
    order, ``i % device_count()``; any other device (``"cpu"``,
    ``"cuda:1"``) puts every position on it. Asking for a card that is not
    there raises."""
    shape = tuple(int(s) for s in shape)
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh extents must be >= 1, got {shape}")
    size = int(np.prod(shape))
    dev = torch.device(device)
    flat = np.empty((size,), dtype=object)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        count = torch.cuda.device_count()
        for i in range(size):
            flat[i] = torch.device("cuda", i % count)
    else:
        dev = resolve_device(dev)
        for i in range(size):
            flat[i] = dev
    return ShardMesh(devices=flat.reshape(shape), axis_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = "cuda") -> ShardMesh:
    """The reference's production shape: 16 x 16 = 256 positions a pod;
    2 pods = 512 multi-pod. Shapes only: the positions are dealt over the
    cards there are."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(device: DeviceLike = "cuda",
                   n_shards: int = 0) -> ShardMesh:
    """A (n, 1) ("data", "model") mesh over what this process has: n is
    ``n_shards`` when given, else the visible cards for ``"cuda"`` and 1
    for the CPU."""
    n = n_shards
    if n <= 0:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            resolve_device(dev)
            n = torch.cuda.device_count()
        else:
            n = 1
    return make_mesh((n, 1), ("data", "model"), device=device)


def mesh_devices(mesh: ShardMesh) -> int:
    """The number of mesh positions."""
    return mesh.size
