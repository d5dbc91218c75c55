"""Warm-path odometer and launch counts for the service telemetry.

Port of ``repro.telemetry.probe``. The reference counts jit-cache entries:
a warm service must never re-lower. The port has no jit; what a warm
service must never do again is *build*: upload a kernel table to a
device, derive a host table, or compile a kernel source. Every
(kind, bucket) shape of a service's lanes is launched once during
warm-up, and later traffic only hits the memos. ``table_cache_entries``
counts that work: the entries of the table memos (``core.cache.
TABLE_MEMOS``), the nvcc compiles of the process (``kernels.build``) and
the per-device copies of each client's keys that the stream executors
cache on the client; any warm-path delta is a regression. The service
snapshot exports it as the ``fhe_table_cache_entries`` gauge.

``launches`` is ``kernels.ops.launches``: each CUDA wrapper's launch
count by kernel (the plain versions count nothing).
"""

from __future__ import annotations

from repro_torch.core import cache
from repro_torch.kernels import build, ops

# attribute under which the stream executors cache a client's copy on
# another device (its keys moved there), keyed by device name
DEVICE_CLIENTS_ATTR = "_stream_device_clients"


def table_cache_entries(clients) -> int:
    """Table-memo entries + nvcc compiles + the listed clients' cached
    per-device copies. A fixed workload replayed against a warm client
    set leaves this UNCHANGED."""
    total = sum(cache.lru_stats(name)["size"] for name in cache.TABLE_MEMOS)
    total += build.builds()
    for c in clients:
        total += len(vars(c).get(DEVICE_CLIENTS_ATTR, {}))
    return total


def launches() -> dict[str, int]:
    """Launches of every CUDA wrapper since the last reset, by kernel."""
    return ops.launches()
