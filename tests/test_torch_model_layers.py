"""The port's model layers (``repro_torch.models.{layers,moe,ssm,mla}``)
against the JAX package's, on the same inputs and weights (JAX weights
carried through ``params_from_numpy``), and the mirrors of
``tests/test_archs.py`` on the port alone.

Tolerances, each against max |ref| of the output (bf16 outputs: one bf16
ulp of that scale, 2^-8; measured values in brackets, on this CPU):

  * exact: rmsnorm in bf16, RoPE and M-RoPE, the bf16 sigmoid (XLA's
    1 / (1 + exp(-x)), each step rounded to bf16), the MoE top-k and its
    two duplicate-index scatters (the drop sink, the bf16 combine);
  * 2^-8: chunked attention [<= 1.9e-4], attention decode [0], MLP [0],
    MoE [0], MLA prefill and decode [0];
  * 2^-7: ssm_fwd / ssm_decode [5.3e-3]. The reference runs jitted here,
    and jitted XLA on the CPU drops the bf16 rounding of a product whose
    only use is a cast to f32 (``y * silu(z)`` into ``rmsnorm``); the
    port rounds there as the reference's own code says (and as the eager
    reference does, bit for bit: 0 of 2048 outputs differ);
  * 1e-5: f32 outputs of the SSD scan and rmsnorm in f32 [2.5e-7];
  * 1e-4: the SSM state after a bf16 prefill [2.8e-5].
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import mla as JMLA
from repro.models import moe as JMOE
from repro.models import ssm as JS
from repro.models import tuning as JT
from repro.models.config import MLAConfig as JMLAConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.config import SSMConfig as JSSMConfig
from repro_torch.models import layers as TL
from repro_torch.models import mla as TMLA
from repro_torch.models import model as M
from repro_torch.models import moe as TMOE
from repro_torch.models import ssm as TS
from repro_torch.models import tuning as TT
from repro_torch.models.archs import ARCHS, get_arch, reduced_config
from repro_torch.models.config import MLAConfig, MoEConfig, SSMConfig

BF = jnp.bfloat16
TBF = torch.bfloat16
ULP = 2.0 ** -8
NAMES = sorted(ARCHS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: small CPU ops run ~100x slower on many
    threads here (they contend for cores with the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(a, dtype="bf16"):
    """numpy -> (jax array, torch tensor) of the same values."""
    if dtype == "bf16":
        return jnp.asarray(a, BF), torch.as_tensor(np.array(a)).to(TBF)
    if dtype == "f32":
        return (jnp.asarray(a, jnp.float32),
                torch.as_tensor(np.array(a, np.float32)))
    return jnp.asarray(a), torch.as_tensor(np.array(a))


def _close(ref, got, tol):
    a, b = _np(ref), _np(got)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(a).max()


def _exact(ref, got):
    np.testing.assert_array_equal(_np(ref), _np(got))


def _carry(tree):
    return M.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _key(i):
    return jax.random.PRNGKey(i)


def _jit(fn, **static):
    """The reference function jitted with its static arguments bound (one
    compile; JAX's op-by-op mode compiles every primitive)."""
    return jax.jit(functools.partial(fn, **static))


RNG = np.random.default_rng(0)
X = RNG.standard_normal((2, 16, 64)).astype(np.float32)


# ---------------------------------------------------------------------------
# layers.py
# ---------------------------------------------------------------------------


def test_rmsnorm_matches_reference():
    g = RNG.standard_normal(64).astype(np.float32)
    xj, xt = _pair(X)
    _exact(JL.rmsnorm(xj, jnp.asarray(g), 1e-5),
           TL.rmsnorm(xt, torch.as_tensor(g), 1e-5))
    xj, xt = _pair(X, "f32")
    _close(JL.rmsnorm(xj, jnp.asarray(g), 1e-6),
           TL.rmsnorm(xt, torch.as_tensor(g), 1e-6), 1e-5)


def test_sigmoid_and_silu_match_reference():
    xj, xt = _pair(RNG.standard_normal((4, 8, 64)) * 4)
    _exact(jax.nn.sigmoid(xj), TL.sigmoid(xt))
    _exact(jax.nn.silu(xj), TL.silu(xt))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_and_mrope_match_reference(theta):
    q = RNG.standard_normal((2, 16, 4, 32))
    pos = (np.broadcast_to(np.arange(16), (2, 16)) + 100).astype(np.int32)
    p3 = np.stack([pos, 2 * pos, pos + 7], -1).astype(np.int32)
    qj, qt = _pair(q)
    _exact(JL.apply_rope(qj, jnp.asarray(pos), theta),
           TL.apply_rope(qt, torch.as_tensor(pos), theta))
    _exact(JL.apply_mrope(qj, jnp.asarray(p3), theta),
           TL.apply_mrope(qt, torch.as_tensor(p3), theta))
    _exact(JL.apply_mrope(qj, jnp.asarray(p3), theta, (4, 4, 8)),
           TL.apply_mrope(qt, torch.as_tensor(p3), theta, (4, 4, 8)))
    # the reference's assert, its type and message
    with pytest.raises(AssertionError, match="sections must cover"):
        JL.apply_mrope(qj, jnp.asarray(p3), theta, (4, 4, 4))
    with pytest.raises(AssertionError, match="sections must cover"):
        TL.apply_mrope(qt, torch.as_tensor(p3), theta, (4, 4, 4))


ATTN_CASES = {
    # (hq, hkv, sq, skv, window, q_chunk, kv_chunk)
    "causal": (4, 4, 64, 64, None, 16, 16),
    "windowed_gqa": (8, 2, 64, 64, 24, 32, 16),
    "decode_offset": (8, 2, 1, 48, None, 16, 16),
    "offset_windowed": (4, 1, 8, 40, 12, 1024, 1024),
    "shrink": (4, 2, 48, 48, None, 32, 32),
    "global_window": (4, 2, 32, 32, 1 << 30, 8, 8),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_matches_reference(case):
    hq, hkv, sq, skv, win, qc, kc = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = (_pair(rng.standard_normal(s)) for s in (
        (2, hq, sq, 32), (2, hkv, skv, 32), (2, hkv, skv, 32)))
    ref = _jit(JL.chunked_attention, window=win, q_chunk=qc,
               kv_chunk=kc)(q[0], k[0], v[0])
    got = TL.chunked_attention(q[1], k[1], v[1], window=win, q_chunk=qc,
                               kv_chunk=kc)
    assert got.dtype == TBF
    _close(ref, got, ULP)
    # unroll is the same loop
    torch.testing.assert_close(got, TL.chunked_attention(
        q[1], k[1], v[1], window=win, q_chunk=qc, kv_chunk=kc, unroll=True),
        rtol=0, atol=0)


@pytest.fixture(scope="module")
def attn():
    dims = JL.AttnDims(64, 4, 2, 16, True)
    jp = JL.init_attention(_key(1), dims)
    for name in ("bq", "bk", "bv"):      # non-zero biases
        jp[name] = jax.random.normal(_key(len(name) + ord(name[1])),
                                     jp[name].shape, jnp.float32)
    return dims, jp, _carry(jp), TL.AttnDims(64, 4, 2, 16, True)


DECODE_CASES = {"linear": (10, False, None), "rolling": (30, True, None),
                "rolling_unfilled": (5, True, None),
                "windowed": (20, False, 8), "global": (23, False, 1 << 30)}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_attention_decode_matches_reference(attn, case):
    dims, jp, tp, tdims = attn
    pos, rolling, win = DECODE_CASES[case]
    x = _pair(RNG.standard_normal((2, 1, 64)))
    ck = _pair(RNG.standard_normal((2, 24, 2, 16)))
    cv = _pair(RNG.standard_normal((2, 24, 2, 16)))
    jo, jk, jv = _jit(JL.attention_decode, dims=dims, theta=1e4,
                      rolling=rolling, window=win)(
        jp, x[0], ck[0], cv[0], jnp.int32(pos))
    to, tk, tv = TL.attention_decode(tp, x[1], ck[1], cv[1], pos, tdims,
                                     theta=1e4, rolling=rolling, window=win)
    _close(jo, to, ULP)
    _exact(jk, tk)
    _exact(jv, tv)
    assert not torch.equal(tk, ck[1])        # written out of place


def test_update_slot_clamps_as_xla():
    """A write past the end lands on the last slot, as
    ``lax.dynamic_update_slice`` clamps it."""
    cache, new = _pair(np.zeros((1, 4, 2))), _pair(np.ones((1, 1, 2)))
    for slot in (2, 4, 9):
        ref = jax.lax.dynamic_update_slice_in_dim(cache[0], new[0], slot, 1)
        _exact(ref, TL.update_slot(cache[1], new[1], slot))


def test_attention_fwd_and_mlp_match_reference(attn):
    dims, jp, tp, tdims = attn
    xj, xt = _pair(X)
    jo, (jk, jv) = _jit(JL.attention_fwd, dims=dims, theta=1e4, q_chunk=8,
                        kv_chunk=8)(jp, xj, window=jnp.int32(6))
    to, (tk, tv) = TL.attention_fwd(tp, xt, tdims, theta=1e4, window=6,
                                    q_chunk=8, kv_chunk=8)
    _close(jo, to, ULP)
    _exact(jk, tk)
    _exact(jv, tv)
    jm = JL.init_mlp(_key(3), 64, 96)
    _close(jax.jit(JL.mlp_fwd)(jm, xj), TL.mlp_fwd(_carry(jm), xt), ULP)


@pytest.mark.parametrize("tie", [False, True])
def test_embed_and_logits_match_reference(tie):
    jp = JL.init_embedding(_key(4), 96, 64, tie)
    tp = _carry(jp)
    toks = RNG.integers(0, 96, (2, 5)).astype(np.int32)
    xj = JL.embed(jp, jnp.asarray(toks))
    xt = TL.embed(tp, torch.as_tensor(toks))
    _exact(xj, xt)
    _close(JL.logits(jp, xj, tie), TL.logits(tp, xt, tie), ULP)


# ---------------------------------------------------------------------------
# moe.py
# ---------------------------------------------------------------------------


MOE_CASES = {
    # (n_experts, top_k, capacity_factor, n_shared)
    "top2": (4, 2, 2.0, 0),
    "top2_overflow_shared": (4, 2, 0.5, 1),
    "top3_overflow": (8, 3, 0.5, 0),
    "top4": (8, 4, 1.0, 1),
    "top8_deepseek_like": (16, 8, 0.25, 1),
}


def _moe_setup(e, k, shared, seed):
    jc = JMoEConfig(n_experts=e, top_k=k, d_ff_expert=64, n_shared=shared)
    tc = MoEConfig(n_experts=e, top_k=k, d_ff_expert=64, n_shared=shared)
    jp = JMOE.init_moe(_key(seed), 32, jc, 48)
    return jc, tc, jp, _carry(jp)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_matches_reference(case):
    e, k, cf, shared = MOE_CASES[case]
    jc, tc, jp, tp = _moe_setup(e, k, shared, e + k)
    xj, xt = _pair(np.random.default_rng(k).standard_normal((2, 24, 32)))
    jo, ja = _jit(JMOE.moe_fwd, cfg=jc, capacity_factor=cf)(jp, xj)
    to, ta = TMOE.moe_fwd(tp, xt, tc, cf)
    _close(jo, to, ULP)
    assert abs(float(ja) - float(ta)) <= 1e-6 * abs(float(ja))


def _ref_slab(xt, topi, topv, e, cap, k):
    """The reference's dispatch scatter (``moe.py:62-81``), in JAX."""
    t, d = xt.shape
    flat_e = topi.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(t), k)
    order = jnp.argsort(flat_e)
    se, st = flat_e[order], flat_t[order]
    same = jnp.cumsum(jnp.ones_like(se)) - 1
    grp_start = jnp.searchsorted(se, jnp.arange(e))
    pos_in_grp = same - grp_start[se]
    keep = pos_in_grp < cap
    slot = se * cap + jnp.where(keep, pos_in_grp, 0)
    src = jnp.where(keep, st, t)
    xt_pad = jnp.concatenate([xt, jnp.zeros((1, d), xt.dtype)])
    slab = jnp.zeros((e * cap, d), xt.dtype).at[
        jnp.where(keep, slot, e * cap - 1)].set(xt_pad[src], mode="drop")
    return slab, (se, st, keep, slot, order)


@pytest.mark.parametrize("overflow", ["last_expert", "other_expert"])
def test_moe_drop_sink_matches_reference(overflow):
    """Dropped tokens write a zero row to slot e*cap-1, the last expert's
    last slot. If the last expert overflows, the reference keeps the zero
    row there (its last write); if another expert overflows and the last
    one is exactly full, the last expert's kept row stays."""
    e, k, cap = 4, 1, 4
    t = 12
    # expert ids per token: last expert gets 6 (> cap) or exactly 4
    ids = ([3] * 6 + [0, 1, 2, 0, 1, 2] if overflow == "last_expert"
           else [3] * 4 + [0] * 6 + [1, 2])
    topi = np.asarray(ids, np.int64)[:, None]
    topv = np.ones((t, 1), np.float32)
    x = np.random.default_rng(3).standard_normal((t, 32)) + 1.0
    xj, xt = _pair(x)
    ref, _ = _ref_slab(xj, jnp.asarray(topi), jnp.asarray(topv), e, cap, k)
    got, _ = TMOE._dispatch(xt, torch.as_tensor(topi), torch.as_tensor(topv),
                            e, cap, k)
    _exact(ref, got.reshape(e * cap, -1))
    sink = _np(got.reshape(e * cap, -1))[-1]
    if overflow == "last_expert":
        assert not sink.any()
    else:
        np.testing.assert_array_equal(sink, _np(xt[3]))


def test_moe_overflowing_router_matches_reference():
    """moe_fwd with a router that sends most tokens to the last expert,
    at a small capacity factor: the sink case end to end."""
    jc, tc, jp, _ = _moe_setup(4, 2, 0, 7)
    jp = dict(jp, router=jp["router"].at[:, 3].add(0.5))
    tp = _carry(jp)
    xj, xt = _pair(np.abs(np.random.default_rng(8)
                          .standard_normal((2, 16, 32))))
    probs, _, topi = TMOE._route(tp, xt.reshape(32, 32), tc)
    cap = max(int(32 * 2 * 0.5 / 4), 4)
    assert int((topi == 3).sum()) > cap               # the last overflows
    jo, _ = _jit(JMOE.moe_fwd, cfg=jc, capacity_factor=0.5)(jp, xj)
    to, _ = TMOE.moe_fwd(tp, xt, tc, 0.5)
    _close(jo, to, ULP)


@pytest.mark.parametrize("k", [2, 3, 8])
def test_moe_combine_order_matches_reference(k):
    """The bf16 ``zeros.at[st].add(contrib)``: one token's k contributions
    summed in ascending expert order, a rounding after each add."""
    e, cap, t, d = 16, 3, 10, 8
    rng = np.random.default_rng(k)
    topi = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    topv = rng.random((t, k)).astype(np.float32)
    xj, xt = _pair(rng.standard_normal((t, d)))
    _, (se, st, keep, slot, order) = _ref_slab(
        xj, jnp.asarray(topi), jnp.asarray(topv), e, cap, k)
    out_slab = rng.standard_normal((e * cap, d)) * 8
    osj, ost = _pair(out_slab)
    sw = jnp.asarray(topv).reshape(-1)[order]
    contrib = osj[slot] * sw[:, None].astype(BF)
    contrib = jnp.where(keep[:, None], contrib, 0)
    ref = jnp.zeros((t, d), BF).at[st].add(contrib, mode="drop")
    _, meta = TMOE._dispatch(xt, torch.as_tensor(topi),
                             torch.as_tensor(topv), e, cap, k)
    _exact(ref, TMOE._combine(ost.reshape(e, cap, d), meta,
                              torch.as_tensor(topi)))


def test_moe_top_k_breaks_ties_as_reference():
    probs = np.asarray([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                        [0.3, 0.2, 0.3, 0.2]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = TMOE.top_k(torch.as_tensor(probs), 2)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("groups", [2, 4])
def test_moe_grouped_dispatch_matches_reference(groups):
    jc, tc, jp, tp = _moe_setup(4, 2, 1, 11)
    xj, xt = _pair(np.random.default_rng(groups).standard_normal((2, 16, 32)))
    JT.set_perf(moe_local_dispatch=groups)
    TT.set_perf(moe_local_dispatch=groups)
    try:
        jo, ja = _jit(JMOE.moe_fwd, cfg=jc, capacity_factor=0.5)(jp, xj)
        to, ta = TMOE.moe_fwd(tp, xt, tc, 0.5)
    finally:
        JT.reset_perf()
        TT.reset_perf()
    _close(jo, to, ULP)
    assert abs(float(ja) - float(ta)) <= 1e-6 * abs(float(ja))
    # 32 tokens in 5 groups: the reference's assert in both packages
    JT.set_perf(moe_local_dispatch=5)
    TT.set_perf(moe_local_dispatch=5)
    try:
        with pytest.raises(AssertionError):
            JMOE.moe_fwd(jp, xj, jc)
        with pytest.raises(AssertionError):
            TMOE.moe_fwd(tp, xt, tc)
    finally:
        JT.reset_perf()
        TT.reset_perf()


def test_tuning_knobs_match_reference():
    assert TT.PERF == JT.PERF
    TT.set_perf(ssd_bf16=True, moe_capacity=1.5)
    assert TT.PERF["ssd_bf16"] and TT.PERF["moe_capacity"] == 1.5
    TT.reset_perf()
    assert TT.PERF == JT.PERF
    with pytest.raises(AssertionError, match="no_such_knob"):
        JT.set_perf(no_such_knob=1)
    with pytest.raises(AssertionError, match="no_such_knob"):
        TT.set_perf(no_such_knob=1)
    x = torch.ones(3)
    assert TT.wsc(x, "data", None) is x


# ---------------------------------------------------------------------------
# ssm.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("perf", ["default", "bf16_chunk4"])
def test_ssd_chunked_matches_reference(perf):
    rng = np.random.default_rng(1)
    args = [rng.standard_normal((2, 32, 4, 8)),
            np.abs(rng.standard_normal((2, 32, 4))) * 0.5,
            rng.standard_normal((2, 32, 16)), rng.standard_normal((2, 32, 16)),
            rng.standard_normal(4) * 0.3]
    pairs = [_pair(a, "f32") for a in args]
    if perf != "default":
        JT.set_perf(ssd_bf16=True, ssd_chunk=4)
        TT.set_perf(ssd_bf16=True, ssd_chunk=4)
    try:
        jy, jf = _jit(JS.ssd_chunked, chunk=8)(*(p[0] for p in pairs))
        ty, tf = TS.ssd_chunked(*(p[1] for p in pairs), 8)
    finally:
        JT.reset_perf()
        TT.reset_perf()
    _close(jy, ty, 1e-5)
    _close(jf, tf, 1e-5)


@pytest.fixture(scope="module")
def ssm():
    sc = JSSMConfig(d_state=16, head_dim=32, expand=2, chunk=8)
    js = JS.init_ssm(_key(5), 64, sc)
    js["a_log"] = jax.random.normal(_key(6), js["a_log"].shape,
                                    jnp.float32) * 0.5
    js["dt_bias"] = jax.random.normal(_key(7), js["dt_bias"].shape,
                                      jnp.float32)
    return sc, js, SSMConfig(d_state=16, head_dim=32, expand=2, chunk=8), \
        _carry(js)


@pytest.mark.parametrize("seq", [16, 24])      # 24: the chunk shrinks to 8
def test_ssm_fwd_and_decode_match_reference(ssm, seq):
    sc, js, tsc, ts = ssm
    xj, xt = _pair(np.random.default_rng(seq).standard_normal((2, seq, 64)))
    jo, (jst, jcv) = _jit(JS.ssm_fwd, cfg=sc, d_model=64)(js, xj)
    to, (tst, tcv) = TS.ssm_fwd(ts, xt, tsc, 64)
    _close(jo, to, 2 * ULP)
    _close(jst, tst, 1e-4)
    _exact(jcv, tcv)
    x1 = _pair(RNG.standard_normal((2, 1, 64)))
    jo, jst, jcv = _jit(JS.ssm_decode, cfg=sc, d_model=64)(js, x1[0], jst,
                                                           jcv)
    to, tst, tcv = TS.ssm_decode(ts, x1[1], tst, tcv, tsc, 64)
    _close(jo, to, 2 * ULP)
    _close(jst, tst, 1e-4)


# ---------------------------------------------------------------------------
# mla.py
# ---------------------------------------------------------------------------


def test_mla_fwd_and_decode_match_reference():
    kw = dict(kv_lora_rank=64, q_lora_rank=96, rope_head_dim=16,
              nope_head_dim=32, v_head_dim=32)
    jc, tc = JMLAConfig(**kw), MLAConfig(**kw)
    jp = JMLA.init_mla(_key(4), 64, 4, jc)
    tp = _carry(jp)
    xj, xt = _pair(X)
    jo, (jcc, jkr) = _jit(JMLA.mla_fwd, n_heads=4, cfg=jc, theta=1e4,
                          q_chunk=8, kv_chunk=8)(jp, xj)
    to, (tcc, tkr) = TMLA.mla_fwd(tp, xt, 4, tc, theta=1e4, q_chunk=8,
                                  kv_chunk=8)
    _close(jo, to, ULP)
    _exact(jcc, tcc)
    _exact(jkr, tkr)
    cc = np.zeros((2, 24, 64))
    cc[:, :16] = _np(jcc)
    kr = np.zeros((2, 24, 16))
    kr[:, :16] = _np(jkr)
    x1, c1, k1 = _pair(RNG.standard_normal((2, 1, 64))), _pair(cc), _pair(kr)
    jo, jc2, jk2 = _jit(JMLA.mla_decode, n_heads=4, cfg=jc, theta=1e4)(
        jp, x1[0], c1[0], k1[0], jnp.int32(16))
    to, tc2, tk2 = TMLA.mla_decode(tp, x1[1], c1[1], k1[1], 16, 4, tc,
                                   theta=1e4)
    _close(jo, to, ULP)
    _exact(jc2, tc2)
    _exact(jk2, tk2)


# ---------------------------------------------------------------------------
# mirrors of tests/test_archs.py, on the port alone
# ---------------------------------------------------------------------------

B, S = 2, 64


def _batch(cfg, seed: int, s: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend:
        batch["embeds"] = torch.as_tensor(rng.standard_normal(
            (B, s, cfg.d_model)).astype(np.float32))
    else:
        batch["tokens"] = torch.as_tensor(
            rng.integers(0, cfg.vocab, (B, s)).astype(np.int32))
    if cfg.mrope:
        batch["mrope_pos"] = torch.arange(s)[None, :, None].expand(
            B, s, 3).to(torch.int32)
    return batch


def _port_params(cfg, seed: int):
    return M.init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_consistency(name):
    """Decode at position S == the full forward's logits over S+1 tokens
    (every cache path: GQA KV, rolling SWA, MLA latent, SSD state)."""
    cfg = reduced_config(get_arch(name))
    params = _port_params(cfg, 1)
    full = _batch(cfg, 2, S + 1)
    lg_full, _ = M.prefill(params, full, cfg, cache_len=S + 1, q_chunk=32,
                           kv_chunk=32)
    pre = {k: v[:, :S] for k, v in full.items()}
    _, cache = M.prefill(params, pre, cfg, cache_len=S + 8, q_chunk=32,
                         kv_chunk=32)
    key = "embeds" if cfg.frontend else "tokens"
    lg_dec, _ = M.decode_step(params, cache, {key: full[key][:, S: S + 1]},
                              S, cfg)
    a, b = _np(lg_full)[:, 0], _np(lg_dec)[:, 0]
    np.testing.assert_allclose(a, b, atol=0.15, rtol=0.05)
    am = b.argmax(-1)
    np.testing.assert_array_less(
        a.max(-1) - np.take_along_axis(a, am[:, None], 1)[:, 0], 0.2)


def test_rolling_swa_cache_matches_full():
    """danube-style uniform SWA: rolling-buffer decode == full-cache math."""
    cfg = reduced_config(get_arch("h2o-danube-3-4b"))
    assert cfg.sliding_window is not None and cfg.swa_every == 1
    params = _port_params(cfg, 2)
    s_long = cfg.sliding_window + 32     # prefill longer than the window
    full = _batch(cfg, 3, s_long + 1)
    lg_full, _ = M.prefill(params, full, cfg, cache_len=s_long + 1,
                           q_chunk=32, kv_chunk=32)
    pre = {k: v[:, :s_long] for k, v in full.items()}
    _, cache = M.prefill(params, pre, cfg, cache_len=s_long + 8, q_chunk=32,
                         kv_chunk=32)
    assert cache.k.shape[2] == cfg.sliding_window   # rolling buffer width
    lg_dec, _ = M.decode_step(
        params, cache, {"tokens": full["tokens"][:, s_long: s_long + 1]},
        s_long, cfg)
    np.testing.assert_allclose(_np(lg_full)[:, 0], _np(lg_dec)[:, 0],
                               atol=0.15, rtol=0.05)


@pytest.mark.parametrize("name", NAMES)
def test_param_accounting(name):
    """param_count() must match the real initialised tree (unpadded, tp=1)."""
    cfg = reduced_config(get_arch(name))
    params = _port_params(cfg, 0)
    true = sum(t.numel() for t in M.tree_leaves(params))
    est = cfg.param_count()
    # estimate excludes norms/bias/conv/mtp (small); agreement within 15%
    assert abs(true - est) / true < 0.15, (name, true, est)


def test_full_configs_exact():
    """Spot-check registry numbers against the assignment table."""
    yi = get_arch("yi-34b")
    assert (yi.n_layers, yi.d_model, yi.n_heads, yi.n_kv_heads,
            yi.d_ff, yi.vocab) == (60, 7168, 56, 8, 20480, 64000)
    ds = get_arch("deepseek-v3-671b")
    assert ds.moe.n_experts == 256 and ds.moe.top_k == 8
    assert ds.mla is not None and ds.mtp_heads == 1
    assert (ds.n_layers, ds.d_model, ds.vocab) == (61, 7168, 129280)
    mm = get_arch("mamba2-130m")
    assert mm.family == "ssm" and mm.ssm.d_state == 128
    hy = get_arch("hymba-1.5b")
    assert hy.family == "hybrid" and hy.ssm.d_state == 16
    phi = get_arch("phi4-mini-3.8b")
    assert phi.vocab == 200064
    assert 30e9 < yi.param_count() < 40e9
    assert 600e9 < get_arch("deepseek-v3-671b").param_count() < 750e9
    a = get_arch("deepseek-v3-671b").active_param_count()
    assert 25e9 < a < 45e9          # ~37B activated
