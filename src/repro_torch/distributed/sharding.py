"""FHE client service: execution streams over the card's devices.

Port of the stream-group part of ``repro.distributed.sharding``. The
client service maps the paper's dual-RSC layout onto the devices: the
device list splits into equal 'stream' groups (each group = one
RSC-equivalent execution stream, one ``torch.cuda.Stream`` per device),
and within a group the batch axis of a (B, L, N) stack splits into equal
row slices, one per device (the reference's ``stream_mesh`` /
``batch_stack_sharding``). The model-parallel sharding of the rest of the
reference module belongs to the LM substrate and is not ported here.
"""

from __future__ import annotations

import torch


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

