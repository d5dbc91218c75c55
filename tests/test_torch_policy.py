"""The port's service policy against the JAX package's, in-process.

The service's policy is framework-free code the port keeps as near-copies:
the dual-RSC round policy and analytic model (``core.scheduler``), the
fleet monitor and re-mesh rule (``distributed.elastic``), and the tenant
identities (``fhe_client.tenancy`` seeds and fingerprints, the service's
``lane_fingerprint``). Each is held equal to the JAX package's function
over a grid of inputs (both packages imported in this process; the JAX
side runs no kernel), and the reference's own unit tests of them
(``tests/test_scheduler.py``, the elastic cases of
``tests/test_distributed.py``) are mirrored on the port. Tolerance: 0
(exact equality of every returned value).
"""

import dataclasses
import itertools

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import scheduler as jax_policy
from repro.core.context import PROFILES as JAX_PROFILES
from repro.distributed import elastic as jax_elastic
from repro.fhe_client import tenancy as jax_tenancy
from repro.fhe_client.service.service import \
    lane_fingerprint as jax_lane_fingerprint
from repro_torch.core import scheduler as policy
from repro_torch.core.context import PROFILES
from repro_torch.distributed.elastic import FleetMonitor, remesh_shape
from repro_torch.distributed import elastic
from repro_torch.fhe_client import tenancy
from repro_torch.fhe_client.service import lane_fingerprint
from repro_torch.core.scheduler import (ClientWorkload, HardwareModel, Job,
                                        Mode, mode_at, schedule)

TENANTS = (None, "alice", "bob", "tenant-42", 7)


def _plan(p):
    """A plan with its Modes as their values (the two packages' Mode enums
    are distinct classes with the same values)."""
    return [(m.value, k) for m, k in p]


# ---------------------------------------------------------------------------
# equal to the JAX package's functions over a grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_streams", [1, 2, 3, 4])
def test_round_policy_equals_reference(n_streams):
    for e, d in itertools.product(range(13), range(6)):
        assert policy.assign_streams(e, d, n_streams) == \
            jax_policy.assign_streams(e, d, n_streams)
        assert _plan(policy.plan_rounds(e, d, n_streams)) == \
            _plan(jax_policy.plan_rounds(e, d, n_streams))
        kinds = policy.assign_streams(e, d, n_streams)
        assert policy.round_mode(kinds).value == \
            jax_policy.round_mode(kinds).value
        assert policy.partial_round(kinds, n_streams) == \
            jax_policy.partial_round(kinds, n_streams)


@pytest.mark.parametrize("mode", policy.FIRE_MODES)
def test_ready_to_fire_equals_reference(mode):
    assert policy.FIRE_MODES == jax_policy.FIRE_MODES
    for n, age, full, wait in itertools.product(
            (0, 1, 3, 4, 16), (0.0, 0.001, 0.005, 1.0), (4, 16),
            (0.0, 0.005, 0.5)):
        assert policy.ready_to_fire(n, age, full, wait, mode) == \
            jax_policy.ready_to_fire(n, age, full, wait, mode)


@pytest.mark.parametrize("logn,enc,dec", [(12, 24, 2), (14, 12, 1),
                                          (16, 24, 2)])
def test_analytic_model_equals_reference(logn, enc, dec):
    w, jw = ClientWorkload(logn, enc, dec), jax_policy.ClientWorkload(
        logn, enc, dec)
    assert (w.op_ratio(), w.op_ratio_fused()) == \
        (jw.op_ratio(), jw.op_ratio_fused())
    for kw in ({}, {"dram_gbps": 819.0}, {"lanes": 4, "n_cores": 1}):
        hw, jhw = HardwareModel(**kw), jax_policy.HardwareModel(**kw)
        assert hw.lane_sweep(w) == jhw.lane_sweep(jw)
        assert hw.memory_ablation(w) == jhw.memory_ablation(jw)
        jobs = [Job("enc", a) for a in (0.0, 0.0, 1e-4)] + [Job("dec")] * 2
        jjobs = [jax_policy.Job(j.kind, j.arrival) for j in jobs]
        span, log = schedule(jobs, hw, w)
        jspan, jlog = jax_policy.schedule(jjobs, jhw, jw)
        assert (span, log) == (jspan, jlog)
        for t in (0.0, span / 3, span / 2, span):
            assert mode_at(log, t).value == mode_at(jlog, t).value


@pytest.mark.parametrize("profile", ["tiny", "test", "paper", "boot"])
def test_tenant_identities_equal_reference(profile):
    p, jp = PROFILES[profile], JAX_PROFILES[profile]
    assert tenancy.params_fingerprint(p) == \
        jax_tenancy.params_fingerprint(jp)
    assert tenancy.params_fingerprint(profile) == \
        jax_tenancy.params_fingerprint(profile)
    variants = [(p, jp), (dataclasses.replace(p, delta_bits=38),
                          dataclasses.replace(jp, delta_bits=38))]
    for (a, b), tid in itertools.product(variants, TENANTS):
        assert tenancy.tenant_seed(a, tid) == jax_tenancy.tenant_seed(b, tid)
        assert lane_fingerprint((tid, a)) == jax_lane_fingerprint((tid, b))
    assert lane_fingerprint(None) == jax_lane_fingerprint(None) == "default"


def _drive(mod, script):
    """Run one event script against a ``FleetMonitor`` of ``mod``; returns
    every decision it made."""
    t = [0.0]
    mon = mod.FleetMonitor(n_hosts=4, heartbeat_timeout=10.0,
                           straggler_factor=1.5, patience=2,
                           clock=lambda: t[0])
    out = []
    for op, *args in script:
        if op == "time":
            t[0] = args[0]
        elif op == "hb":
            mon.heartbeat(args[0])
        elif op == "step":
            mon.report_step_time(*args)
        elif op == "fail":
            out.append(mon.mark_failed(args[0]))
        elif op == "revive":
            mon.revive(args[0])
        elif op == "check":
            out.append(mon.check_failures())
        elif op == "slow":
            out.append(mon.stragglers())
        out.append(list(mon.alive_hosts))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_fleet_monitor_decisions_equal_reference(seed):
    import random
    rng = random.Random(seed)
    script, t = [], 0.0
    for _ in range(120):
        op = rng.choice(("time", "hb", "step", "step", "fail", "revive",
                         "check", "slow"))
        if op == "time":
            t += rng.choice((1.0, 4.0, 12.0))
            script.append(("time", t))
        elif op == "step":
            script.append(("step", rng.randrange(4),
                           rng.choice((1.0, 1.1, 2.2, 3.0))))
        elif op in ("hb", "fail", "revive"):
            script.append((op, rng.randrange(4)))
        else:
            script.append((op,))
    assert _drive(elastic, script) == _drive(jax_elastic, script)
    for n in (1, 2, 4, 16, 48, 240, 256, 512, 768):
        assert remesh_shape(n) == jax_elastic.remesh_shape(n)


# ---------------------------------------------------------------------------
# the reference's unit tests of the policy, on the port
# ---------------------------------------------------------------------------


def test_round_policy_matches_rsc_modes():
    assert policy.assign_streams(10, 1) == ("dec", "enc")
    assert policy.assign_streams(9, 0) == ("enc", "enc")
    assert policy.assign_streams(0, 3) == ("dec", "dec")
    assert policy.round_mode(("enc", "enc")) is Mode.ENC2
    assert policy.round_mode(("dec", "dec")) is Mode.DEC2
    assert policy.round_mode(("dec", "enc")) is Mode.MIX
    assert policy.round_mode(("enc",)) is Mode.MIX
    plan = policy.plan_rounds(5, 1, 2)
    assert [m for m, _k in plan] == [Mode.MIX, Mode.ENC2, Mode.ENC2]
    for e, d, s in ((0, 4, 2), (7, 0, 1), (3, 3, 4)):
        kinds = [k for _m, ks in policy.plan_rounds(e, d, s) for k in ks]
        assert kinds.count("enc") == e and kinds.count("dec") == d


def test_single_stream_never_starves_decrypts():
    kinds = [k for _m, ks in policy.plan_rounds(10, 2, 1) for k in ks]
    assert kinds[:2] == ["dec", "dec"] and kinds[2:] == ["enc"] * 10


def test_ready_to_fire_policy():
    for mode in policy.FIRE_MODES:
        assert policy.ready_to_fire(4, 0.0, 4, 1.0, mode)
        assert not policy.ready_to_fire(0, 99.0, 4, 0.0, mode)
    assert not policy.ready_to_fire(1, 0.001, 4, 0.005, "deadline")
    assert policy.ready_to_fire(1, 0.005, 4, 0.005, "deadline")
    assert policy.ready_to_fire(1, 0.0, 4, 9.0, "eager")
    assert not policy.ready_to_fire(3, 99.0, 4, 0.0, "full")
    with pytest.raises(ValueError):
        policy.ready_to_fire(1, 0.0, 4, 1.0, "bogus")
    assert policy.partial_round(("enc",), 2)
    assert not policy.partial_round(("enc", "dec"), 2)
    assert not policy.partial_round((), 2)


def test_op_imbalance_order_of_magnitude():
    w = ClientWorkload(logn=16, enc_limbs=24, dec_limbs=2)
    assert w.op_ratio() > 5
    assert 5 < w.op_ratio_fused() < 15


def test_lane_knee_matches_paper():
    sweep = HardwareModel().lane_sweep(ClientWorkload(logn=16),
                                       lanes_list=(1, 2, 4, 8, 16, 32))
    knee = next(p for p, _s, _c, bound in sweep if bound == "memory")
    assert knee == 8
    thr = [c for _p, _s, c, _b in sweep]
    assert thr[4] / thr[3] < 1.1


def test_memory_ablation_ordering():
    abl = HardwareModel().memory_ablation(ClientWorkload(logn=16))
    assert abl["base"] > abl["tf_gen"] > abl["all"]
    assert 3.0 < abl["base"] / abl["all"] < 12.0


def test_hbm_shifts_knee():
    sweep = HardwareModel(dram_gbps=819.0).lane_sweep(
        ClientWorkload(logn=16), lanes_list=(8, 16, 32))
    assert all(b == "compute" for _p, _s, _c, b in sweep)


def test_schedule_two_cores_beat_one():
    hw, w = HardwareModel(), ClientWorkload(logn=14)
    jobs = [Job("enc")] * 10 + [Job("dec")] * 1
    makespan, log = schedule(jobs, hw, w)
    serial = sum(hw.job_seconds(w, j.kind == "enc") for j in jobs)
    assert makespan < serial * 0.6
    assert mode_at(log, makespan / 2) in (Mode.ENC2, Mode.MIX)


@settings(max_examples=25, deadline=None)
@given(n_enc=st.integers(0, 20), n_dec=st.integers(0, 20))
def test_schedule_invariants(n_enc, n_dec):
    hw, w = HardwareModel(), ClientWorkload(logn=12)
    jobs = [Job("enc")] * n_enc + [Job("dec")] * n_dec
    makespan, log = schedule(jobs, hw, w)
    serial = sum(hw.job_seconds(w, j.kind == "enc") for j in jobs)
    assert len(log) == len(jobs)
    assert makespan <= serial + 1e-12
    if jobs:
        assert makespan >= serial / 2 - 1e-12
    per_core: dict = {}
    for _kind, core, s, e in log:
        for (s2, e2) in per_core.get(core, []):
            assert e <= s2 or s >= e2
        per_core.setdefault(core, []).append((s, e))


def test_elastic_remesh_policy():
    assert remesh_shape(512) == ((2, 16, 16), ("pod", "data", "model"))
    assert remesh_shape(256) == ((16, 16), ("data", "model"))
    assert remesh_shape(240) == ((15, 16), ("data", "model"))
    assert remesh_shape(4) == ((1, 4), ("data", "model"))
    assert remesh_shape(1) == ((1, 1), ("data", "model"))


def test_fleet_monitor_failure_and_straggler():
    t = [0.0]
    mon = FleetMonitor(n_hosts=4, heartbeat_timeout=10.0,
                       straggler_factor=1.5, patience=2, clock=lambda: t[0])
    for h in range(4):
        mon.heartbeat(h)
    t[0] = 15.0
    for h in range(3):
        mon.heartbeat(h)
    t[0] = 20.0
    assert mon.check_failures() == [3]
    assert mon.alive_hosts == [0, 1, 2]
    for _ in range(3):
        for h, dt in ((0, 1.0), (1, 1.0), (2, 2.2)):
            mon.report_step_time(h, dt)
        slow = mon.stragglers()
    assert slow == [2]


def test_fleet_monitor_mark_failed_and_revive():
    t = [0.0]
    mon = FleetMonitor(n_hosts=2, heartbeat_timeout=10.0, clock=lambda: t[0])
    assert mon.mark_failed(0) is True
    assert mon.mark_failed(0) is False
    assert mon.alive_hosts == [1]
    t[0] = 100.0
    mon.revive(0)
    assert mon.alive_hosts == [0, 1]
    t[0] = 105.0
    assert mon.check_failures() == [1]


def test_fleet_monitor_stragglers_idempotent_across_polls():
    mon = FleetMonitor(n_hosts=3, straggler_factor=1.5, patience=2,
                       clock=lambda: 0.0)
    for h, dt in ((0, 1.0), (1, 1.0), (2, 2.2)):
        mon.report_step_time(h, dt)
    assert mon.stragglers() == [] and mon.stragglers() == []
    assert mon.hosts[2].slow_streak == 1
    for h, dt in ((0, 1.0), (1, 1.0), (2, 2.2)):
        mon.report_step_time(h, dt)
    assert mon.stragglers() == [2] and mon.stragglers() == [2]
    for h, dt in ((0, 1.0), (1, 1.0), (2, 1.0)):
        mon.report_step_time(h, dt)
    assert mon.stragglers() == [] and mon.hosts[2].slow_streak == 0
