"""Content-keyed bounded LRU caches for derived CKKS/NTT state, and the
hit/miss/eviction counters of every memo of the port.

Port of ``repro.core.cache``. ``LRUCache`` (a bounded, thread-safe
``OrderedDict`` memo that registers under a name for ``cache_stats``) is
the reference's. The port memoises its derived tables with ``functools.lru_cache`` (bounded,
keyed by content: primes, ring degree, profile parameters and the device
name, never by ``id``), so ``cache_stats`` reports those next to the named
``LRUCache`` memos, under the reference's names where a memo has a
counterpart (``plan_consts``, ``stacked_kernel_consts``, ``server_consts``,
``stacked_plans``, ``ntt_plans``, ``ntt_primes``; ``contexts`` is an
``LRUCache``, as in the reference). ``plan_key`` / ``plans_key`` are the
reference's content keys of a plan and of a plan stack.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable


def plan_key(plan) -> tuple[int, int]:
    """Content key of an NTTPlan: ``(q, N)`` determines every derived
    constant."""
    return (int(plan.prime.q), int(plan.n))


def plans_key(plans) -> tuple[tuple[int, int], ...]:
    """Content key of an ordered plan stack."""
    return tuple(plan_key(p) for p in plans)


# named caches register here so the telemetry layer can walk every
# bounded memo's hit/miss/eviction counters (``cache_stats``) without the
# cache module depending on telemetry. Module-global memos live for the
# process, so a plain dict (no weakrefs) is the right lifetime.
_NAMED_CACHES: dict[str, "LRUCache"] = {}
_NAMED_LOCK = threading.Lock()


class LRUCache:
    """Bounded content-keyed memo: ``get_or_build(key, build)`` with LRU
    eviction past ``capacity``. An optional ``on_evict(key, value)`` hook
    lets owners release dependent state.

    Thread-safe: the module-global memos built on this are hit
    concurrently by user threads, the service dispatch thread and the
    completion thread, so every operation — including the check-build-put
    sequence of ``get_or_build`` — runs under one re-entrant lock. Holding
    the lock across ``build()`` serializes same-cache cold builds, which
    is exactly what prevents two threads from double-building expensive
    derived state (and from evicting entries out from under each other);
    nested use of the same cache from inside a build is fine (RLock).

    Observability: ``hits``/``misses``/``evictions`` are plain counters
    bumped under the existing lock (no extra cost on the hot path); a
    ``name`` registers the cache for ``cache_stats()``, which the
    telemetry snapshot exports as gauges."""

    def __init__(self, capacity: int, on_evict: Callable | None = None,
                 name: str | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.name = name
        self._data: OrderedDict = OrderedDict()
        self._on_evict = on_evict
        self._lock = threading.RLock()
        self.evictions = 0
        self.hits = 0
        self.misses = 0
        if name is not None:
            with _NAMED_LOCK:
                _NAMED_CACHES[name] = self

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._data

    def get(self, key, default=None):
        with self._lock:
            if key in self._data:
                self.hits += 1
                self._data.move_to_end(key)
                return self._data[key]
            self.misses += 1
            return default

    def get_or_build(self, key, build: Callable):
        with self._lock:
            if key in self._data:
                self.hits += 1
                self._data.move_to_end(key)
                return self._data[key]
            self.misses += 1
            value = build()
            self._data[key] = value
            self._data.move_to_end(key)
            self._trim_locked()
            return value

    def put(self, key, value) -> None:
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            self._trim_locked()

    def pop(self, key, default=None):
        with self._lock:
            return self._data.pop(key, default)

    def set_capacity(self, capacity: int) -> int:
        """Change the bound (evicting down if needed); returns the old."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        with self._lock:
            old, self.capacity = self.capacity, int(capacity)
            self._trim_locked()
            return old

    def _trim_locked(self) -> None:
        while len(self._data) > self.capacity:
            key, value = self._data.popitem(last=False)
            self.evictions += 1
            if self._on_evict is not None:
                self._on_evict(key, value)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def keys(self):
        with self._lock:
            return list(self._data.keys())

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._data), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


# functools.lru_cache memos of the port: name -> (module, attribute). The
# first six carry the reference's names (``contexts`` is a named
# ``LRUCache``, as in the reference); the rest are the port's device
# tables (uploaded once per device) and host tables of the kernels.
LRU_MEMOS = {
    "plan_consts": ("repro_torch.kernels.common", "_plan_consts"),
    "stacked_kernel_consts": ("repro_torch.kernels.common", "_stacked_kc"),
    "server_consts": ("repro_torch.kernels.server_eval", "server_consts"),
    "stacked_plans": ("repro_torch.core.context", "_stacked"),
    "ntt_plans": ("repro_torch.core.ntt", "make_plan"),
    "ntt_primes": ("repro_torch.core.primes", "find_ntt_friendly_primes"),
    "device_seed_tables": ("repro_torch.kernels.common",
                           "_device_seed_table"),
    "sa_rows": ("repro_torch.kernels.common", "sa_rows"),
    "device_sa_tables": ("repro_torch.kernels.common", "_device_sa_table"),
    "stream_bitrev": ("repro_torch.kernels.client_stream", "_bitrev"),
    "stream_device_tables": ("repro_torch.kernels.client_stream",
                             "_device_tables"),
}

# the memos that hold the kernels' tables: what a warm service must not
# add to (``telemetry.probe.table_cache_entries``)
TABLE_MEMOS = ("plan_consts", "stacked_kernel_consts", "device_seed_tables",
               "sa_rows", "device_sa_tables", "stream_bitrev",
               "stream_device_tables")


def _memo(name: str):
    import importlib
    mod, attr = LRU_MEMOS[name]
    return getattr(importlib.import_module(mod), attr)


def lru_stats(name: str) -> dict:
    """{size, capacity, hits, misses, evictions} of one
    ``functools.lru_cache`` memo of ``LRU_MEMOS``, read through
    ``cache_info()``."""
    info = _memo(name).cache_info()
    return {"size": info.currsize, "capacity": info.maxsize,
            "hits": info.hits, "misses": info.misses,
            "evictions": max(0, info.misses - info.currsize)}


def cache_stats() -> dict:
    """{name: {size, capacity, hits, misses, evictions}} over every bounded
    derived-state memo of the process: the named ``LRUCache`` memos plus
    the ``functools.lru_cache`` memos of ``LRU_MEMOS``. The telemetry
    snapshot exports these as gauges; the imports are lazy so
    ``core.cache`` stays dependency-free."""
    with _NAMED_LOCK:
        out = {name: c.stats() for name, c in sorted(_NAMED_CACHES.items())}
    for name in LRU_MEMOS:
        out[name] = lru_stats(name)
    return out
