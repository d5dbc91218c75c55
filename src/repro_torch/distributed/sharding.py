"""Logical-axis sharding rules for every parameter tree, activation,
optimizer state and decode cache, and the client service's execution
streams over the card's devices.

Port of ``repro.distributed.sharding``.

Model half. Mesh: (data=16, model=16) single-pod; (pod=2, data=16,
model=16) multi-pod (``launch.mesh``). Policy (MaxText/Megatron-style
hybrid), the reference's rules word for word:
  * TP over 'model': attention head / d_ff / vocab / expert-ff dims.
  * FSDP (ZeRO-3) over 'data': the d_model ("other") dim of every matrix —
    weights are gathered per layer on use; optimizer state stays sharded.
  * EP over 'data': MoE expert dim (deepseek: 256 experts / 16 = 16 per row).
  * DP over 'pod' (+'data' for activations): batch dim.
  * decode KV caches: batch->data, sequence->model (sequence sharding keeps
    the 32k x 128-batch caches under 1 GB/device); long_500k (batch=1)
    shards sequence over BOTH axes.
  * rolling SWA caches: small (window-sized); batch->data only.

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dim, each None (replicated), an axis name, or a tuple of axis names
(major to minor). The rules read only a mesh's axis names and sizes, so
they take a ``launch.mesh.MeshSpec`` and a
``torch.distributed.device_mesh.DeviceMesh`` alike; ``NamedSpec`` pairs a
mesh with a spec (the reference's ``NamedSharding``): ``shard_shape``
gives a device's shard of a global shape and ``placements`` the DTensor
placements (``Shard(d)`` / ``Replicate()``, one per mesh dim) for
``torch.distributed.tensor.distribute_tensor``.

Stream half. The client service maps the paper's dual-RSC layout onto the
devices: the device list splits into equal 'stream' groups (each group =
one RSC-equivalent execution stream, one ``torch.cuda.Stream`` per
device), and within a group the batch axis of a (B, L, N) stack splits
into equal row slices, one per device (``stream_mesh`` /
``batch_stack_sharding``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch.mesh import MeshSpec
from repro_torch.models.config import ArchConfig


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``MeshSpec`` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshSpec):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names")
    return dict(zip(names, tuple(mesh.mesh.shape)))


def _axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh_axes(mesh))


def _ndim(leaf) -> int:
    return len(leaf.shape)


def batch_axes(mesh):
    return (("pod", "data") if "pod" in _axis_names(mesh) else "data")


def axis_size(mesh, axis) -> int:
    names = (axis,) if isinstance(axis, str) else axis
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in names)


def _dim_ok(size: int, mesh, axis) -> bool:
    if axis is None:
        return True
    return size % axis_size(mesh, axis) == 0


@dataclasses.dataclass(frozen=True)
class NamedSpec:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: object
    spec: tuple

    def shard_shape(self, global_shape) -> tuple:
        """One device's shard of ``global_shape`` (every sharded dim
        divides, as the rules guarantee)."""
        out = list(global_shape)
        for d, axis in enumerate(self.spec):
            if axis is not None:
                n = axis_size(self.mesh, axis)
                if out[d] % n:
                    raise ValueError(f"dim {d} of {tuple(global_shape)} "
                                     f"does not divide over {axis}")
                out[d] //= n
        return tuple(out)

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: ``Shard(d)`` where tensor
        dim d is split over that mesh axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in _axis_names(self.mesh):
            dims = [d for d, axis in enumerate(self.spec)
                    if axis == name or (isinstance(axis, tuple)
                                        and name in axis)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def _spec_for_matrix(key: str, shape, mesh, stacked: bool) -> tuple:
    """(in_dim, out_dim) matrices -> (data, model) / (model, data)."""
    lead = (None,) if stacked else ()
    d_in, d_out = shape[-2], shape[-1]

    def pick(row_axis, col_axis):
        row = row_axis if _dim_ok(d_in, mesh, row_axis) else None
        col = col_axis if _dim_ok(d_out, mesh, col_axis) else None
        return (*lead, row, col)

    # output-dim TP (column parallel): wq/wk/wv, mlp wi/wg, low-rank a/b...
    col_parallel = ("wq", "wk", "wv", "wi", "wg", "wq_a", "wq_b",
                    "wkv_a", "wk_b", "wv_b", "w_in")
    # input-dim TP (row parallel): wo, w_out
    row_parallel = ("wo", "w_out")
    if key in col_parallel:
        return pick("data", "model")
    if key in row_parallel:
        return pick("model", "data")
    if key == "router":
        return pick("data", None)
    return (*lead, *([None] * 2))


def param_spec(path_keys: list[str], leaf, mesh) -> tuple:
    """Spec for one parameter, by path pattern."""
    key = path_keys[-1]
    stacked = path_keys[0] == "layers"
    shape = leaf.shape
    ndim = _ndim(leaf)

    # embeddings
    if key == "tok":
        v_ax = "model" if _dim_ok(shape[0], mesh, "model") else None
        d_ax = "data" if _dim_ok(shape[1], mesh, "data") else None
        return (v_ax, d_ax)
    if key == "unembed":
        d_ax = "data" if _dim_ok(shape[0], mesh, "data") else None
        v_ax = "model" if _dim_ok(shape[1], mesh, "model") else None
        return (d_ax, v_ax)

    # MoE experts: (L, E, d, f) / (L, E, f, d) -> EP over data, TP over f
    if "moe" in path_keys and key in ("wi", "wg", "wo") and ndim >= 3 \
            and "shared" not in path_keys:
        lead = (None,) if stacked else ()
        e, a, b = shape[-3], shape[-2], shape[-1]
        e_ax = "data" if _dim_ok(e, mesh, "data") else None
        if key in ("wi", "wg"):      # (E, d, f): f -> model
            f_ax = "model" if _dim_ok(b, mesh, "model") else None
            return (*lead, e_ax, None, f_ax)
        f_ax = "model" if _dim_ok(a, mesh, "model") else None
        return (*lead, e_ax, f_ax, None)

    if ndim >= 2 and key in ("wq", "wk", "wv", "wo", "wi", "wg",
                             "w_in", "w_out", "router", "wq_a", "wq_b",
                             "wkv_a", "wk_b", "wv_b"):
        return _spec_for_matrix(key, shape, mesh, stacked)

    # vectors / conv / scalars: replicate
    return (None,) * ndim


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(list(path), tree)


def param_shardings(params, mesh):
    return _map_with_path(
        lambda keys, leaf: NamedSpec(mesh, param_spec(keys, leaf, mesh)),
        params)


def opt_state_shardings(opt_state, mesh):
    """8-bit moment blocks: shard block dim over (data, model) when it
    divides; scales follow; replicate otherwise."""
    names = _axis_names(mesh)
    nd = math.prod(mesh_axes(mesh).values())

    def one(_keys, leaf):
        ndim = _ndim(leaf)
        if ndim >= 1 and leaf.shape[0] % nd == 0:
            return NamedSpec(mesh, (names, *([None] * (ndim - 1))))
        return NamedSpec(mesh, (None,) * ndim)
    return _map_with_path(one, opt_state)


def batch_shardings(batch, mesh):
    ba = batch_axes(mesh)

    def one(_keys, leaf):
        ndim = _ndim(leaf)
        if ndim == 0:
            return NamedSpec(mesh, ())
        if not _dim_ok(leaf.shape[0], mesh, ba):
            return NamedSpec(mesh, (None,) * ndim)
        return NamedSpec(mesh, (ba, *([None] * (ndim - 1))))
    return _map_with_path(one, batch)


def cache_shardings(cache_tree, mesh, cfg: ArchConfig,
                    long_context: bool = False):
    """Decode-cache shardings. Leaves are (L, B, S, ...) or SSM states;
    ``cache_tree`` is a ``models.model.Cache`` of leaves or None."""
    ba = batch_axes(mesh)

    def one(leaf):
        if leaf is None:
            return None
        shape = leaf.shape
        ndim = _ndim(leaf)
        if ndim >= 4 and shape[2] > 1024:               # (L, B, S, ...)
            if long_context and shape[1] == 1:
                s_ax = _axis_names(mesh)                # S over everything
                spec = [None, None,
                        s_ax if _dim_ok(shape[2], mesh, s_ax) else None]
            else:
                spec = [None,
                        ba if _dim_ok(shape[1], mesh, ba) else None,
                        "model" if _dim_ok(shape[2], mesh, "model")
                        else None]
            spec += [None] * (ndim - 3)
            return NamedSpec(mesh, tuple(spec))
        # SSM state (L,B,H,hd,ds) / conv (L,B,W-1,C) / rolling KV
        spec = [None,
                ba if _dim_ok(shape[1], mesh, ba) else None]
        spec += [None] * (ndim - 2)
        return NamedSpec(mesh, tuple(spec))

    return dataclasses.replace(cache_tree, **{
        f.name: one(getattr(cache_tree, f.name))
        for f in dataclasses.fields(cache_tree)})


def replicated(mesh):
    return NamedSpec(mesh, ())


# ---------------------------------------------------------------------------
# FHE client service: device streams over the ciphertext batch axis
# ---------------------------------------------------------------------------


def cuda_devices() -> list:
    """Every CUDA device of the process, as ``torch.device('cuda', i)``;
    raises when there is none (the service has no CPU default: a caller
    that means the CPU passes CPU devices)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device: the client service runs its "
                           "streams on the card; pass devices="
                           "[torch.device('cpu')] * k for logical CPU "
                           "devices")
    return [torch.device("cuda", i) for i in range(n)]


def normalize_device(device) -> torch.device:
    """``torch.device`` with an explicit index for CUDA (``'cuda'`` is the
    current device), so two names of one card compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def stream_groups(devices=None, n_streams: int | None = None,
                  oversubscribe: bool = False) -> list:
    """Split devices into ``n_streams`` equal-size groups (default: two
    streams — the paper's two RSCs — or one when only one device exists).
    Remainder devices are left idle so every group splits the same
    bucketed batch shapes. ``devices`` defaults to every CUDA device.

    ``oversubscribe=True`` allows more streams than devices: streams are
    assigned devices round-robin (1 device per stream). Oversubscribed
    streams are *logical* dispatch queues and failure domains sharing
    hardware; on one card each is its own CUDA stream, so their kernels
    may overlap on the device.
    """
    devices = tuple(cuda_devices() if devices is None else
                    (normalize_device(d) for d in devices))
    if n_streams is None:
        n_streams = min(2, len(devices))
    if oversubscribe and n_streams > len(devices):
        if n_streams < 1:
            raise ValueError(f"n_streams={n_streams} must be >= 1")
        return [[devices[i % len(devices)]] for i in range(n_streams)]
    if not 1 <= n_streams <= len(devices):
        raise ValueError(f"n_streams={n_streams} needs 1..{len(devices)} "
                         f"for {len(devices)} devices (pass "
                         f"oversubscribe=True for logical streams sharing "
                         f"devices)")
    per = len(devices) // n_streams
    return [list(devices[i * per:(i + 1) * per]) for i in range(n_streams)]



def stream_mesh(devices) -> MeshSpec:
    """1-D ('batch',) mesh over one stream group's devices."""
    devices = tuple(normalize_device(d) for d in devices)
    return MeshSpec(("batch",), (len(devices),), devices)


def batch_stack_sharding(mesh, ndim: int) -> NamedSpec:
    """Spec for a (B, ...) client stack: batch axis over 'batch' (equal
    row slices, one a device: ``kernels.ops.split_rows``)."""
    return NamedSpec(mesh, ("batch", *([None] * (ndim - 1))))
