"""Elastic scaling + straggler/failure handling for the launcher.

On a real multi-pod deployment the heartbeat monitor runs per host; here the
same logic is exercised by tests with simulated clocks. The policy is the
standard large-fleet one:

  * heartbeat timeout -> host marked dead -> re-mesh event
  * re-mesh: pick the largest (pods, data, model) mesh that fits the
    surviving device count, restore the latest checkpoint onto it (the
    checkpoint layer reshards by name), resume from the checkpointed step —
    data pipeline state is just the step counter, so no data is skipped
    or repeated.
  * straggler mitigation: per-step host timings; hosts slower than
    `straggler_factor` x median for `patience` consecutive steps are
    reported (and, on capable fleets, drained + replaced).

Port of ``repro.distributed.elastic``: no framework code, a near-copy.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class HostState:
    last_heartbeat: float
    step_times: list = dataclasses.field(default_factory=list)
    slow_streak: int = 0
    alive: bool = True
    # streak idempotency: how many step reports exist vs how many the
    # straggler judge has already counted toward the streak
    reported_steps: int = 0
    judged_steps: int = 0


class FleetMonitor:
    def __init__(self, n_hosts: int, heartbeat_timeout: float = 60.0,
                 straggler_factor: float = 1.5, patience: int = 3,
                 clock=time.monotonic):
        self.clock = clock
        self.timeout = heartbeat_timeout
        self.factor = straggler_factor
        self.patience = patience
        now = clock()
        self.hosts = {i: HostState(now) for i in range(n_hosts)}

    # --- liveness ---------------------------------------------------------

    def heartbeat(self, host: int):
        self.hosts[host].last_heartbeat = self.clock()

    def check_failures(self) -> list[int]:
        now = self.clock()
        dead = []
        for hid, h in self.hosts.items():
            if h.alive and now - h.last_heartbeat > self.timeout:
                h.alive = False
                dead.append(hid)
        return dead

    def mark_failed(self, host: int) -> bool:
        """Explicitly declare a host dead (an error was *observed*, not
        just a missed heartbeat — e.g. a service stream raised mid-round).
        Returns True if the host was alive. The client-service runtime
        reuses the monitor this way: streams heartbeat on completed jobs,
        launch/materialize errors mark-failed immediately, and silent
        hangs fall to ``check_failures``'s timeout."""
        h = self.hosts[host]
        was_alive = h.alive
        h.alive = False
        return was_alive

    def revive(self, host: int):
        """Bring a replaced/recovered host back (fresh heartbeat, clean
        straggler streak)."""
        h = self.hosts[host]
        h.alive = True
        h.slow_streak = 0
        h.judged_steps = h.reported_steps
        h.last_heartbeat = self.clock()

    @property
    def alive_hosts(self) -> list[int]:
        return [h for h, s in self.hosts.items() if s.alive]

    # --- stragglers --------------------------------------------------------

    def report_step_time(self, host: int, seconds: float):
        h = self.hosts[host]
        h.step_times.append(seconds)
        h.reported_steps += 1
        if len(h.step_times) > 16:
            h.step_times.pop(0)

    def stragglers(self) -> list[int]:
        """Hosts whose latest step was > factor x median for `patience`
        consecutive reported steps. Idempotent per reported step: each
        report is judged toward the streak exactly once, so a caller that
        polls twice between reports (the mesh router does, from its own
        loop) cannot double-count toward `patience`."""
        import statistics
        alive = [h for h in self.hosts.values() if h.alive and h.step_times]
        if len(alive) < 2:
            return []
        med = statistics.median(h.step_times[-1] for h in alive)
        out = []
        for hid, h in self.hosts.items():
            if not h.alive or not h.step_times:
                continue
            if h.judged_steps < h.reported_steps:
                h.judged_steps = h.reported_steps
                if h.step_times[-1] > self.factor * med:
                    h.slow_streak += 1
                else:
                    h.slow_streak = 0
            if h.slow_streak >= self.patience:
                out.append(hid)
        return out


def remesh_shape(n_devices: int, model_width: int = 16,
                 pod_size: int = 256) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest (pod, data, model) mesh fitting `n_devices`, keeping the
    model axis fixed (TP width is an architecture property) and shrinking
    data/pod — the elastic policy. On fleets smaller than `model_width`
    the model axis clamps to the device count (a mesh must FIT: 4 devices
    must never yield a 16-wide model axis)."""
    if n_devices >= 2 * pod_size and n_devices % pod_size == 0:
        pods = n_devices // pod_size
        return ((pods, pod_size // model_width, model_width),
                ("pod", "data", "model"))
    model = max(1, min(model_width, n_devices))
    data = max(n_devices // model, 1)
    return ((data, model), ("data", "model"))
