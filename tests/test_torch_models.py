"""The port's LM substrate (``repro_torch.models``) against the JAX package.

For each of the 10 architectures at ``reduced_config`` (2 layers, d_model
128, vocab 512), with the same weights in both packages: the prefill
logits, every cache leaf, 3 decode steps (each step fed the reference's
greedy token) and the ``train_fwd`` loss. The weights are drawn by the
port's ``init_params``; their tree is held equal, key for key in shape and
dtype, to the JAX package's ``init_params`` (``jax.eval_shape``), and they
reach the port through ``params_from_numpy``, as any carried JAX weights
would. The reference runs jitted, once per architecture per file.

Tolerances (bf16 compute; module-level parity is exact or within one bf16
ulp, ``test_torch_model_layers.py``; what remains is f32 summation order
in the products and reductions, rounding an output to a neighbouring bf16
a few times per layer):

  * logits (prefill and each decode step): max |port - ref| <= 3e-2 *
    max |ref| (measured: <= 1.6e-2, hymba's third decode step);
  * greedy tokens equal wherever the reference's top-2 margin exceeds
    that tolerance;
  * caches: each leaf's max |port - ref| <= 3e-2 * max |ref| (measured <=
    1.3e-2). An MoE router whose k-th and (k+1)-th probabilities are
    within ``ROUTER_GAP`` of each other may pick the other expert under a
    bf16 ulp of input (phi3.5-moe token 7 of row 0, gap 3.4e-4 in the
    reference): the cache rows of such tokens past layer 0 are left out
    (at most 5 % of the rows; 2 of 128 in phi3.5-moe);
  * ``train_fwd`` loss: |port - ref| <= 2e-3 * |ref| (measured <= 9.1e-4).

Configs, parameter counts of every full config, cache specs and layer
windows equal the JAX package's, exactly. The mirrors of
``tests/test_archs.py`` are in ``test_torch_model_layers.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import shapes as jax_shapes
from repro.models import archs as jax_archs
from repro.models import model as JM
from repro_torch.configs import shapes
from repro_torch.models import archs, moe
from repro_torch.models import model as M
from repro_torch.models.archs import ARCHS, get_arch, reduced_config

B, S = 2, 64
LOGIT_TOL = 3e-2
CACHE_TOL = 3e-2
LOSS_TOL = 2e-3
ROUTER_GAP = 1e-3
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
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _batch(cfg, seed: int, s: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend:
        batch["embeds"] = rng.standard_normal(
            (B, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    if cfg.mrope:
        batch["mrope_pos"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(s)[None, :, None], (B, s, 3)).astype(np.int32))
    return batch


def _tt(batch) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jj(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _shapes(tree) -> dict:
    """{key path: (shape, dtype name)} of a params tree (either package)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out[path] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    walk(tree, ())
    return out


class _Run:
    """One architecture's reference and port runs on the same inputs."""

    def __init__(self, name: str):
        self.cfg = cfg = reduced_config(get_arch(name))
        self.jcfg = jcfg = jax_archs.reduced_config(jax_archs.get_arch(name))
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        self.tree = _shapes(params)
        self.ref_tree = _shapes(jax.eval_shape(
            lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))))
        carried = M.tree_map(lambda t: t.numpy(), params)
        jp = M.tree_map(jnp.asarray, carried)
        self.params = M.params_from_numpy(carried, device="cpu")
        batch = _batch(cfg, 1, S + 3)
        pre = {k: v[:, :S] for k, v in batch.items() if k != "labels"}

        prefill = jax.jit(functools.partial(
            JM.prefill, cfg=jcfg, cache_len=S + 8, q_chunk=32, kv_chunk=32))
        decode = jax.jit(functools.partial(JM.decode_step, cfg=jcfg))
        lg, cache = prefill(jp, _jj(pre))
        self.ref_logits = [_np(lg)]
        self.ref_cache = {f: _np(getattr(cache, f)) for f in M.FIELDS
                          if getattr(cache, f) is not None}

        # the port's layer-0 MoE router input, for the near-tie rows
        seen = []
        real = moe.moe_fwd

        def spy(p, x, *a, **k):
            seen.append(x)
            return real(p, x, *a, **k)

        moe.moe_fwd = spy
        try:
            tl, tc = M.prefill(self.params, _tt(pre), cfg, cache_len=S + 8,
                               q_chunk=32, kv_chunk=32)
        finally:
            moe.moe_fwd = real
        self.logits = [_np(tl)]
        self.cache = {f: _np(getattr(tc, f)) for f in M.FIELDS
                      if getattr(tc, f) is not None}
        self.near_tie = np.zeros((B, S), bool)
        if cfg.moe:
            lp0 = M._layer(self.params, 0)["moe"]
            probs, _, _ = moe._route(lp0, seen[0].reshape(B * S, -1),
                                     cfg.moe)
            top = torch.sort(probs, -1, descending=True).values
            k = cfg.moe.top_k
            self.near_tie = ((top[:, k - 1] - top[:, k]) < ROUTER_GAP
                             ).numpy().reshape(B, S)

        for i in range(3):
            if cfg.frontend:
                step = {"embeds": batch["embeds"][:, S + i: S + i + 1]}
            else:
                step = {"tokens": self.ref_logits[-1][:, :, : cfg.vocab]
                        .argmax(-1).astype(np.int32)}
            lg, cache = decode(jp, cache, _jj(step), jnp.int32(S + i))
            tl, tc = M.decode_step(self.params, tc, _tt(step), S + i, cfg)
            self.ref_logits.append(_np(lg))
            self.logits.append(_np(tl))

        train = {k: v[:, :S] for k, v in batch.items()}
        self.ref_loss = float(jax.jit(functools.partial(
            JM.train_fwd, cfg=jcfg, q_chunk=32, kv_chunk=32))(
                jp, _jj(train)))
        self.loss = float(M.train_fwd(self.params, _tt(train), cfg,
                                      q_chunk=32, kv_chunk=32))


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _Run(name)
        return cache[name]
    return get


# ---------------------------------------------------------------------------
# parity with the JAX package, all 10 archs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_param_tree_matches_reference(runs, name):
    r = runs(name)
    assert r.tree == r.ref_tree


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_match_reference(runs, name):
    r = runs(name)
    a, b = r.ref_logits[0], r.logits[0]
    assert b.shape == a.shape == (B, 1, r.cfg.padded_vocab(1))
    assert np.abs(a - b).max() <= LOGIT_TOL * np.abs(a).max()


@pytest.mark.parametrize("name", NAMES)
def test_cache_matches_reference(runs, name):
    r = runs(name)
    assert set(r.cache) == set(r.ref_cache)
    assert r.near_tie.mean() <= 0.05
    for f, a in r.ref_cache.items():
        b = r.cache[f]
        assert b.shape == a.shape, f
        if f in ("k", "v", "mla_c", "mla_kr") and r.near_tie.any():
            # a near-tie row may route to the other expert from layer 1 on
            rows = np.ones(a.shape[:3], bool)
            rows[1:, :, :S] = ~r.near_tie
            a, b = a[rows], b[rows]
        assert np.abs(a - b).max() <= CACHE_TOL * np.abs(a).max(), f


@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_reference(runs, name):
    r = runs(name)
    for a, b in zip(r.ref_logits[1:], r.logits[1:]):
        assert np.abs(a - b).max() <= LOGIT_TOL * np.abs(a).max()


@pytest.mark.parametrize("name", NAMES)
def test_greedy_tokens_match_reference(runs, name):
    r = runs(name)
    checked = 0
    for a, b in zip(r.ref_logits, r.logits):
        a, b = a[:, -1, : r.cfg.vocab], b[:, -1, : r.cfg.vocab]
        top2 = np.sort(a, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > LOGIT_TOL * np.abs(a).max()
        np.testing.assert_array_equal(a.argmax(-1)[clear],
                                      b.argmax(-1)[clear])
        checked += clear.sum()
    assert checked >= 4


@pytest.mark.parametrize("name", NAMES)
def test_train_loss_matches_reference(runs, name):
    r = runs(name)
    assert np.isfinite(r.loss)
    assert abs(r.loss - r.ref_loss) <= LOSS_TOL * abs(r.ref_loss)


# ---------------------------------------------------------------------------
# configs equal to the JAX package's
# ---------------------------------------------------------------------------


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", NAMES)
def test_configs_equal_reference(name):
    """Full and reduced configs, field for field, and the parameter /
    flop accounting of the full config, exactly."""
    cfg, ref = get_arch(name), jax_archs.get_arch(name)
    assert _fields(cfg) == _fields(ref)
    assert _fields(reduced_config(cfg)) == _fields(
        jax_archs.reduced_config(ref))
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cfg.model_flops_per_token() == ref.model_flops_per_token()
    for tp in (1, 2, 8, 16):
        if cfg.n_heads:
            assert cfg.padded_heads(tp) == ref.padded_heads(tp)
        else:           # attention-free: no heads to pad, in either package
            for c in (cfg, ref):
                with pytest.raises(ZeroDivisionError):
                    c.padded_heads(tp)
        assert cfg.padded_vocab(tp) == ref.padded_vocab(tp)
    assert (cfg.hd, cfg.attention_free, cfg.subquadratic) == (
        ref.hd, ref.attention_free, ref.subquadratic)


def test_config_modules_and_shapes_equal_reference():
    import importlib
    from pathlib import Path
    ref_dir = Path(jax_shapes.__file__).parent
    mods = sorted(p.stem for p in ref_dir.glob("*.py") if p.stem != "shapes")
    assert len(mods) == len(NAMES)
    for mod in mods:
        port = importlib.import_module(f"repro_torch.configs.{mod}")
        ref = importlib.import_module(f"repro.configs.{mod}")
        assert _fields(port.config()) == _fields(ref.config())
        assert _fields(port.smoke_config()) == _fields(ref.smoke_config())
    assert {k: _fields(v) for k, v in shapes.SHAPES.items()} == {
        k: _fields(v) for k, v in jax_shapes.SHAPES.items()}
    for name in NAMES:
        for shape in shapes.SHAPES:
            assert shapes.runnable(get_arch(name), shape) == \
                jax_shapes.runnable(jax_archs.get_arch(name), shape)
    assert archs.ARCHS.keys() == jax_archs.ARCHS.keys()
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-2")


def _port_params(cfg, seed: int):
    return M.init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")


def test_rolling_swa_cache_matches_reference():
    """The rolling cache past the window (trim, then roll so slot(p) =
    p mod window) and two decodes that wrap it, against the JAX package."""
    cfg = reduced_config(get_arch("h2o-danube-3-4b"))
    jcfg = jax_archs.reduced_config(jax_archs.get_arch("h2o-danube-3-4b"))
    params = _port_params(cfg, 4)
    jp = M.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    s_long = cfg.sliding_window + 32     # prefill longer than the window
    toks = _batch(cfg, 5, s_long + 2)["tokens"]
    prefill = jax.jit(functools.partial(
        JM.prefill, cfg=jcfg, cache_len=s_long + 8, q_chunk=32, kv_chunk=32))
    decode = jax.jit(functools.partial(JM.decode_step, cfg=jcfg))
    jl, jc = prefill(jp, {"tokens": jnp.asarray(toks[:, :s_long])})
    tl, tc = M.prefill(params, {"tokens": torch.as_tensor(
        toks[:, :s_long])}, cfg, cache_len=s_long + 8, q_chunk=32,
        kv_chunk=32)
    for i in range(2):
        a, b = _np(jc.k), _np(tc.k)
        assert b.shape == a.shape == (cfg.n_layers, B, cfg.sliding_window,
                                      1, cfg.hd)
        assert np.abs(a - b).max() <= CACHE_TOL * np.abs(a).max()
        step = toks[:, s_long + i: s_long + i + 1]
        jl, jc = decode(jp, jc, {"tokens": jnp.asarray(step)},
                        jnp.int32(s_long + i))
        tl, tc = M.decode_step(params, tc, {"tokens": torch.as_tensor(step)},
                               s_long + i, cfg)
        a, b = _np(jl), _np(tl)
        assert np.abs(a - b).max() <= LOGIT_TOL * np.abs(a).max()


def test_hymba_layer_windows_match_reference():
    """Global layers at 0, 16 (every swa_every-th) of hymba's 32, SWA 1024
    elsewhere; -1 is the global window 2^30 in the layer body."""
    cfg = get_arch("hymba-1.5b")
    w = M._layer_windows(cfg)
    np.testing.assert_array_equal(
        w, JM._layer_windows(jax_archs.get_arch("hymba-1.5b")))
    assert list(np.flatnonzero(w < 0)) == [0, 16]
    assert M._window(-1) == 1 << 30 and M._window(1024) == 1024
    for name in NAMES:
        np.testing.assert_array_equal(
            M._layer_windows(get_arch(name)),
            JM._layer_windows(jax_archs.get_arch(name)))


def test_cache_spec_matches_reference():
    """Shapes and dtypes of the decode cache, every family, tp 1 and 8."""
    for name in NAMES:
        cfg = get_arch(name)
        for tp in (1, 8):
            port = M.cache_spec(cfg, 4, 4096, tp)
            ref = JM.cache_spec(jax_archs.get_arch(name), 4, 4096, tp)
            for f in M.FIELDS:
                p, r = getattr(port, f), getattr(ref, f)
                assert (p is None) == (r is None), (name, f)
                if p is not None:
                    assert p.shape == tuple(r.shape), (name, f)
                    assert str(p.dtype).replace("torch.", "") == \
                        str(r.dtype), (name, f)
