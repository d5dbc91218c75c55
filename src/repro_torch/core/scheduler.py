"""Dual-RSC task scheduler + analytic streaming-performance model
(paper §III top level, Fig. 5a/5b latency, Fig. 6b memory ablation).

ABC-FHE has two homogeneous Reconfigurable Streaming Cores with three modes:
2xENC (both cores encode/encrypt), 2xDEC, or ENC+DEC. The client workload is
~10:1 encrypt-heavy (Fig. 2b), so the scheduler packs job queues to minimise
makespan. The same scheduler drives stream assignment on the GPUs (each
"core" = one CUDA stream over a device group) — the policy is
hardware-agnostic.

Port of ``repro.core.scheduler``: no framework code, a near-copy.

The analytic model reproduces the paper's design-space curves:
  * lane sweep (Fig. 5b): P-lane MDC pipeline is compute-bound until the
    LPDDR5 link saturates; beyond the knee, more lanes buy nothing.
  * memory ablation (Fig. 6b): Base (twiddles+randomness from DRAM) vs
    TF_Gen (twiddles on-chip) vs All (PRNG too) — the All config removes
    ~90% of DRAM traffic and yields the paper's 8-9x latency gap.

Model constants are the paper's: 600 MHz clock, LPDDR5 68.4 GB/s.
"""

from __future__ import annotations

import dataclasses
from enum import Enum


# ---------------------------------------------------------------------------
# Workload accounting (paper Fig. 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClientWorkload:
    """Transform/pointwise op counts for one ciphertext at (logn, limbs)."""
    logn: int
    enc_limbs: int = 24     # fresh ciphertext limbs (encode+encrypt)
    dec_limbs: int = 2      # server-returned limbs (decode+decrypt)

    @property
    def n(self):
        return 1 << self.logn

    def transforms_enc(self) -> int:
        # 1 IFFT (encode) + NTT per limb for v, e0, e1 is folded on-chip;
        # streaming datapath: 1 IFFT + 3*L NTT of small polys + pointwise
        return 1 + 3 * self.enc_limbs

    def transforms_dec(self) -> int:
        return 1 + self.dec_limbs          # 1 FFT + INTT per limb

    def butterflies(self, n_transforms: int) -> int:
        return n_transforms * (self.n // 2) * self.logn

    def op_ratio(self) -> float:
        """encrypt-bundle ops / decrypt-bundle ops (paper: ~10x)."""
        return (self.butterflies(self.transforms_enc())
                / self.butterflies(self.transforms_dec()))

    @staticmethod
    def paper_basis() -> "ClientWorkload":
        """Fig. 2b accounting basis: 12-level encryption, 1-level
        decryption, one NTT per limb in the fused datapath (errors folded
        in coefficient domain before the streaming NTT)."""
        return ClientWorkload(logn=16, enc_limbs=12, dec_limbs=1)

    def op_ratio_fused(self) -> float:
        """Ratio when v/e0/e1 share one fused NTT pass per limb."""
        enc = 1 + self.enc_limbs
        dec = 1 + self.dec_limbs
        return self.butterflies(enc) / self.butterflies(dec)

    # --- DRAM traffic per ciphertext (bytes), by configuration -------------

    def bytes_io(self, enc: bool) -> int:
        """Irreducible traffic: message in / ciphertext out (or reverse)."""
        msg = self.n * 8                       # fp64-equivalent slots
        ct_limbs = self.enc_limbs if enc else self.dec_limbs
        ct = 2 * ct_limbs * self.n * 4
        return msg + ct

    def bytes_twiddles(self, enc: bool) -> int:
        limbs = self.enc_limbs if enc else self.dec_limbs
        n_tf = (self.transforms_enc() if enc else self.transforms_dec())
        del limbs
        return n_tf * self.n * 4               # one table pass per transform

    def bytes_randomness(self, enc: bool) -> int:
        if not enc:
            return 0
        # public key (2 limb-polys) + v, e0, e1 masks/errors per limb
        return (2 + 3) * self.enc_limbs * self.n * 4


class Mode(Enum):
    ENC2 = "2xENC"
    DEC2 = "2xDEC"
    MIX = "ENC+DEC"


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Streaming-core analytic model (defaults = paper constants).

    ``dram_efficiency``: achievable fraction of peak DRAM bandwidth for the
    streaming access pattern. Calibrated to 0.2 so the LPDDR5 lane sweep
    saturates at P=8 as the paper reports (Fig. 5b) — LPDDR5 efficiency of
    20-40% is typical for mixed-granularity streams; 1.0 = ideal link.
    """
    clock_hz: float = 600e6
    dram_gbps: float = 68.4          # LPDDR5
    dram_efficiency: float = 0.25
    lanes: int = 8                   # P
    n_cores: int = 2                 # RSC count

    def bytes_per_cycle(self, shared: bool = True) -> float:
        """Per-core effective DRAM bytes/cycle. Both RSCs share the one
        LPDDR5 link (that is what caps useful lanes at P=8, Fig. 5b)."""
        share = self.n_cores if shared else 1
        return (self.dram_gbps * 1e9 * self.dram_efficiency
                / self.clock_hz / share)

    # --- single-job latency on one core -------------------------------------

    def job_cycles(self, w: ClientWorkload, enc: bool,
                   otf_twiddles: bool = True, onchip_prng: bool = True,
                   lanes: int | None = None) -> float:
        """Streaming latency model. The irreducible message/ct I/O stream
        is double-buffered (overlaps compute: max). Parameter fetches
        (twiddles / randomness / keys in the Base configs) are hot-path
        dependencies consumed at line rate — they STALL the pipe, so their
        cycles add (the paper's Fig. 6b gap comes from exactly this)."""
        p = lanes or self.lanes
        n_tf = w.transforms_enc() if enc else w.transforms_dec()
        # pipelined MDC lane: N/P cycles per streamed transform + fill
        fill = w.logn * 4                      # stage latency (pipe fill)
        compute = n_tf * (w.n / p) + fill
        bpc = self.bytes_per_cycle()
        stall = 0.0
        if not otf_twiddles:
            stall += w.bytes_twiddles(enc) / bpc
        if not onchip_prng:
            stall += w.bytes_randomness(enc) / bpc
        mem = w.bytes_io(enc) / bpc
        return max(compute, mem) + stall

    def job_seconds(self, w, enc, **kw) -> float:
        return self.job_cycles(w, enc, **kw) / self.clock_hz

    # --- Fig. 5b: lane sweep -------------------------------------------------

    def lane_sweep(self, w: ClientWorkload, lanes_list=(1, 2, 4, 8, 16, 32)):
        """[(P, enc_seconds, ct/s, bound)] — shows the LPDDR5 knee."""
        out = []
        for p in lanes_list:
            cyc = self.job_cycles(w, enc=True, lanes=p)
            bound = ("memory" if w.bytes_io(True) / self.bytes_per_cycle()
                     > w.transforms_enc() * (w.n / p) else "compute")
            out.append((p, cyc / self.clock_hz,
                        self.clock_hz / cyc * self.n_cores, bound))
        return out

    # --- Fig. 6b: memory ablation ---------------------------------------------

    def memory_ablation(self, w: ClientWorkload):
        """{config: enc+dec seconds} for Base / TF_Gen / All."""
        def total(otf, prng):
            return (self.job_seconds(w, True, otf_twiddles=otf,
                                     onchip_prng=prng)
                    + self.job_seconds(w, False, otf_twiddles=otf,
                                       onchip_prng=prng))
        return {
            "base": total(False, False),
            "tf_gen": total(True, False),
            "all": total(True, True),
        }


# ---------------------------------------------------------------------------
# Dual-core scheduler (3 modes, makespan-minimising)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Job:
    kind: str            # 'enc' | 'dec'
    arrival: float = 0.0


def schedule(jobs: list[Job], hw: HardwareModel, w: ClientWorkload):
    """Greedy list-scheduling of enc/dec jobs onto the two cores.

    Returns (makespan_seconds, mode_log). Each core is a stream: a job
    occupies one core for its streaming latency; the effective top-level
    mode at any instant is derived from what the two cores run — matching
    the paper's three operating modes.
    """
    t_enc = hw.job_seconds(w, enc=True)
    t_dec = hw.job_seconds(w, enc=False)
    cores = [0.0] * hw.n_cores
    log = []
    # longest-processing-time first within arrival order
    ordered = sorted(jobs, key=lambda j: (j.arrival,
                                          -(t_enc if j.kind == "enc"
                                            else t_dec)))
    for job in ordered:
        dur = t_enc if job.kind == "enc" else t_dec
        i = min(range(len(cores)), key=lambda k: cores[k])
        start = max(cores[i], job.arrival)
        cores[i] = start + dur
        log.append((job.kind, i, start, cores[i]))
    makespan = max(cores) if cores else 0.0
    return makespan, log


def mode_at(log, t: float) -> Mode:
    active = [k for k, _c, s, e in log if s <= t < e]
    if active.count("enc") >= 2:
        return Mode.ENC2
    if active.count("dec") >= 2:
        return Mode.DEC2
    return Mode.MIX


# ---------------------------------------------------------------------------
# Round-based dispatch policy (shared with the executing service)
# ---------------------------------------------------------------------------
#
# The analytic ``schedule`` above prices jobs in seconds; the serving layer
# (``repro_torch.fhe_client.service``) dispatches whole *batch jobs* to device
# streams in rounds. Both must agree on the paper's mode policy, so the
# round policy lives here as pure functions of queue occupancy:
# ``assign_streams`` picks what each stream runs next, ``plan_rounds``
# unrolls a queue snapshot into the full (mode, kinds) schedule. The
# service's dispatch log must replay ``plan_rounds`` exactly — tests assert
# policy/execution agreement through this seam.


def assign_streams(n_enc: int, n_dec: int, n_streams: int = 2) -> tuple:
    """Job kinds the streams run next, given pending-queue occupancy.

    Mirrors the three RSC operating modes: when both queues are pending
    the round covers both kinds first (ENC+DEC), decode ahead of encode —
    decode jobs are latency-critical server returns (and ~10x cheaper,
    Fig. 2b) and must not starve behind the encrypt backlog, which also
    keeps a single-stream deployment alternating instead of draining the
    encrypt queue first. Extra streams then feed the longer queue; a
    single pending kind fills every stream (2xENC / 2xDEC).
    """
    kinds: list = []
    e, d = n_enc, n_dec
    for _ in range(n_streams):
        if not e and not d:
            break
        if d and (not e or "dec" not in kinds):
            k = "dec"
        elif e and (not d or "enc" not in kinds):
            k = "enc"
        else:
            k = "enc" if e >= d else "dec"
        e, d = (e - 1, d) if k == "enc" else (e, d - 1)
        kinds.append(k)
    return tuple(kinds)


def round_mode(kinds) -> Mode:
    """Operating mode implied by one round's stream assignment (same
    convention as ``mode_at``: anything short of two same-kind streams is
    the mixed mode)."""
    ks = tuple(kinds)
    if len(ks) >= 2 and all(k == "enc" for k in ks):
        return Mode.ENC2
    if len(ks) >= 2 and all(k == "dec" for k in ks):
        return Mode.DEC2
    return Mode.MIX


def plan_rounds(n_enc: int, n_dec: int, n_streams: int = 2) -> list:
    """Unrolled [(mode, kinds)] dispatch plan for a queue snapshot of
    ``n_enc`` encrypt-batch and ``n_dec`` decrypt-batch jobs.

    ``n_streams`` is the number of *alive* streams: a degraded service
    (stream failures re-queued its jobs onto survivors) plans with the
    surviving count, so the single-stream fallback and the fault-recovery
    path replay the same policy as a 1-stream deployment.
    """
    out = []
    e, d = n_enc, n_dec
    while e or d:
        kinds = assign_streams(e, d, n_streams)
        out.append((round_mode(kinds), kinds))
        e -= kinds.count("enc")
        d -= kinds.count("dec")
    return out


# ---------------------------------------------------------------------------
# Partial-round firing policy (the always-on dispatch loop)
# ---------------------------------------------------------------------------
#
# An explicit flush() drains everything, so every round is as full as the
# queues allow. The background dispatch loop instead decides *when* a
# partially-filled bucket may dispatch at all — the paper's host interface
# keeps the RSCs busy under a sustained stream, which on our side means
# trading a little batching efficiency (partial buckets waste padded rows)
# for bounded per-request latency. Three named modes:
#
#   'deadline' (default) — full buckets fire immediately; a partial bucket
#       fires only once its oldest request has waited ``max_wait``.
#   'eager'  — anything pending fires every loop tick (minimum latency,
#       worst padding waste; the closed-loop flush() behaviour).
#   'full'   — only full buckets ever fire on the loop; partial tails wait
#       for an explicit flush/stop drain (maximum batching efficiency).

FIRE_MODES = ("deadline", "eager", "full")


def ready_to_fire(n_pending: int, oldest_age: float, full_bucket: int,
                  max_wait: float, mode: str = "deadline") -> bool:
    """Whether a queue with ``n_pending`` requests (oldest waiting
    ``oldest_age`` seconds) should dispatch now, given the largest bucket
    ``full_bucket`` and the per-request ``max_wait`` deadline."""
    if mode not in FIRE_MODES:
        raise ValueError(f"fire mode must be one of {FIRE_MODES}, "
                         f"got {mode!r}")
    if n_pending <= 0:
        return False
    if n_pending >= full_bucket:
        return True
    if mode == "eager":
        return True
    if mode == "full":
        return False
    return oldest_age >= max_wait


def partial_round(kinds, n_streams: int) -> bool:
    """True when a round leaves streams idle (fewer jobs than alive
    streams) — the deadline-fire telemetry marks these so operators can
    see how much of the fleet a latency-driven dispatch wasted."""
    return 0 < len(tuple(kinds)) < n_streams
