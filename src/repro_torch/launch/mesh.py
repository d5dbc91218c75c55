"""Production mesh descriptions.

Port of ``repro.launch.mesh``: ``make_production_mesh`` gives the
reference's (16, 16) ``('data', 'model')`` single-pod mesh, or (2, 16, 16)
``('pod', 'data', 'model')`` across two pods; ``make_mesh`` any shape.
They return a ``MeshSpec`` — axis names and sizes, no devices — because
that is all the sharding rules (``distributed.sharding``) and the dry-run
(``launch.dryrun``) read; the rules take a real
``torch.distributed.device_mesh.DeviceMesh`` alike. Functions, not
module-level constants: importing this module touches no device and starts
no process group.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A device mesh by its axis names and sizes (major to minor);
    ``devices`` optionally names its devices in row-major order (a stream
    group's, ``sharding.stream_mesh``)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple | None = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, as a JAX ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Number of devices."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshSpec(axes, shape)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> MeshSpec:
    """Arbitrary mesh (elastic re-mesh path)."""
    return MeshSpec(tuple(axes), tuple(int(s) for s in shape))


def tp_width(mesh) -> int:
    from repro_torch.distributed.sharding import mesh_axes
    axes = mesh_axes(mesh)
    return axes["model"] if "model" in axes else 1
