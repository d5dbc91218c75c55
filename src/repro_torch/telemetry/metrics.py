"""Labeled metrics registry: counters, gauges, fixed-bucket histograms.

The serving stack's observability was fragmented (``faults.EventLog``
events, ``ClientService.stats()`` point-in-time counters, per-rid latency
dicts, a bench-private table-cache probe); this module is the one surface
they all land on. Design constraints, in order:

  * **Lock-cheap recording.** One ``threading.Lock`` per metric; a record
    is a dict lookup plus a float add (histograms: one bisect). The hot
    path (submit/coalesce/launch/materialize, three threads) never takes
    a registry-wide lock and never allocates per record once a label set
    is live.
  * **Bounded label cardinality.** Every metric holds at most
    ``max_series`` label sets; the first record past the bound lands on a
    single ``overflow`` series instead of growing the map (a misbehaving
    label — say a raw tenant id instead of a lane fingerprint — degrades
    a metric, never memory). DESIGN.md §8 documents the bound.
  * **No payload capture.** Metrics hold numbers and label strings only.
    Label values for lanes are FINGERPRINTS (``lane_fingerprint``), never
    message plaintext, keys, seeds, or raw tenant identifiers.

Exports: ``snapshot()`` (JSON-able dict, the CI artifact format) and
``exposition()`` (Prometheus text format, the scrape endpoint a serving
shim would mount).

Port of ``repro.telemetry.metrics``: no framework code, a near-copy.
"""

from __future__ import annotations

import bisect
import threading

# value that absorbs records past the per-metric label-cardinality bound
OVERFLOW_LABEL = "overflow"

# 1-2-5 ladder from 1 us to 60 s + inf: wide enough for interpret-mode CPU
# runs (ms..s) and GPU runs (us) without reconfiguration.
DEFAULT_TIME_BUCKETS = tuple(
    m * (10.0 ** e) for e in range(-6, 2) for m in (1.0, 2.0, 5.0)
) + (60.0,)


class _Metric:
    """Shared labeled-series machinery. A series is keyed by a tuple of
    label values (in ``labelnames`` order); recording against an unseen
    set past ``max_series`` folds into the overflow series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames=(),
                 max_series: int = 64):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def _cell(self, key: tuple):
        """Series cell for a label-value key (caller holds the lock)."""
        cell = self._series.get(key)
        if cell is None:
            if len(self._series) >= self.max_series:
                key = (OVERFLOW_LABEL,) * len(self.labelnames)
                cell = self._series.get(key)
                if cell is not None:
                    return cell
            cell = self._series[key] = self._new_cell()
        return cell

    def _new_cell(self):
        raise NotImplementedError

    def series(self) -> dict:
        """{label-value tuple: cell snapshot} — stable copies."""
        with self._lock:
            return {k: self._freeze(c) for k, c in self._series.items()}

    def _freeze(self, cell):
        return cell

    def reset(self) -> None:
        """Drop every series (window boundary); registration survives."""
        with self._lock:
            self._series.clear()

    def n_series(self) -> int:
        with self._lock:
            return len(self._series)


class Counter(_Metric):
    """Monotone within a telemetry window (``reset`` starts a new one)."""

    kind = "counter"

    def _new_cell(self):
        return [0.0]

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._cell(key)[0] += amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            cell = self._series.get(key)
            return cell[0] if cell is not None else 0.0

    def _freeze(self, cell):
        return cell[0]


class Gauge(_Metric):
    """Point-in-time value (queue depth, residents, table-cache entries)."""

    kind = "gauge"

    def _new_cell(self):
        return [0.0]

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._cell(key)[0] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._cell(key)[0] += amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            cell = self._series.get(key)
            return cell[0] if cell is not None else 0.0

    def _freeze(self, cell):
        return cell[0]


class _HistCell:
    __slots__ = ("counts", "total", "sum")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # +1: the +inf bucket
        self.total = 0
        self.sum = 0.0


class Histogram(_Metric):
    """Fixed-boundary histogram (upper bounds, +inf implicit).

    Quantiles are estimated from the cumulative bucket counts with linear
    interpolation inside the containing bucket — exact enough for p50/p99
    reporting against ~3 buckets/decade boundaries, and O(buckets) with no
    per-observation storage (the property the private latency lists this
    replaces did not have)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labelnames=(),
                 buckets=DEFAULT_TIME_BUCKETS, max_series: int = 64):
        super().__init__(name, help, labelnames, max_series)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds

    def _new_cell(self):
        return _HistCell(len(self.bounds))

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            cell = self._cell(key)
            cell.counts[i] += 1
            cell.total += 1
            cell.sum += value

    def _freeze(self, cell):
        return {"counts": list(cell.counts), "total": cell.total,
                "sum": cell.sum}

    # -- summaries ----------------------------------------------------------

    def _quantile_from(self, counts, total, q: float) -> float:
        if total <= 0:
            return 0.0
        rank = q * total
        seen = 0.0
        lo = 0.0
        for i, c in enumerate(counts):
            hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
            if seen + c >= rank:
                if c == 0:
                    return hi
                frac = (rank - seen) / c
                return lo + frac * (hi - lo)
            seen += c
            lo = hi
        return self.bounds[-1]

    def summary(self, quantiles=(0.5, 0.99), **labels) -> dict:
        """{'count', 'sum', 'p50', 'p99', ...} for one label set (zeros if
        the series never recorded)."""
        key = self._key(labels)
        with self._lock:
            cell = self._series.get(key)
            counts = list(cell.counts) if cell is not None else []
            total = cell.total if cell is not None else 0
            s = cell.sum if cell is not None else 0.0
        out = {"count": total, "sum": s}
        for q in quantiles:
            out[f"p{int(q * 100)}"] = self._quantile_from(counts, total, q)
        return out

    def total_count(self, **labels) -> int:
        key = self._key(labels)
        with self._lock:
            cell = self._series.get(key)
            return cell.total if cell is not None else 0


class MetricsRegistry:
    """Named metric instruments, one instance per telemetry scope.

    ``counter/gauge/histogram`` register-or-return by name (idempotent, so
    instrumented layers can look instruments up without threading object
    references around); ``snapshot`` and ``exposition`` walk every
    registered metric.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _register(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.labelnames}")
                return m
            m = cls(name, help=help, labelnames=labelnames, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=(), **kw) -> Counter:
        return self._register(Counter, name, help, labelnames, **kw)

    def gauge(self, name, help="", labelnames=(), **kw) -> Gauge:
        return self._register(Gauge, name, help, labelnames, **kw)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_TIME_BUCKETS, **kw) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets, **kw)

    def get(self, name) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def reset(self) -> None:
        """New telemetry window: every series drops to empty, every
        registration (names, labels, bucket boundaries) survives."""
        for m in self.metrics():
            m.reset()

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able dump: {metric: {kind, help, labels, series: [...]}}.
        Histogram series carry bucket bounds + counts so consumers (CI
        artifacts, the benches) can derive their own quantiles."""
        out = {}
        for m in self.metrics():
            series = []
            for key, val in sorted(m.series().items()):
                entry = {"labels": dict(zip(m.labelnames, key))}
                if m.kind == "histogram":
                    entry.update(val)
                else:
                    entry["value"] = val
                series.append(entry)
            out[m.name] = {"kind": m.kind, "help": m.help,
                           "labels": list(m.labelnames), "series": series}
            if m.kind == "histogram":
                out[m.name]["bounds"] = list(m.bounds)
        return out

    def exposition(self) -> str:
        """Prometheus text exposition format (one block per metric)."""
        lines = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, val in sorted(m.series().items()):
                lbl = ",".join(f'{n}="{v}"'
                               for n, v in zip(m.labelnames, key))
                if m.kind == "histogram":
                    cum = 0
                    for i, c in enumerate(val["counts"]):
                        cum += c
                        le = (f"{m.bounds[i]:g}" if i < len(m.bounds)
                              else "+Inf")
                        blbl = (lbl + "," if lbl else "") + f'le="{le}"'
                        lines.append(
                            f"{m.name}_bucket{{{blbl}}} {cum}")
                    suffix = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{m.name}_sum{suffix} {val['sum']:g}")
                    lines.append(f"{m.name}_count{suffix} {val['total']}")
                else:
                    suffix = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{m.name}{suffix} {val:g}")
        return "\n".join(lines) + "\n"
