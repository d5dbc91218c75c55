"""The port's training path against the JAX package, on the CPU.

``repro_torch.training`` (8-bit AdamW, int8 gradient compression, the
train step), ``data.pipeline.Prefetcher``, ``distributed.checkpoint`` and
``launch.train`` / ``launch.train_lm``. The mirrors of
``tests/test_system.py`` and of the optimizer and checkpoint cases of
``tests/test_distributed.py`` run on the port alone; the parity cases
hold the port against the JAX package on the same inputs (the port's
params, drawn by ``init_params`` and carried as numpy; the batches of
``synth_batch``).

Parity figures, each with its tolerance:

  * ``_q8``: the int8 payload and the scales bit-identical to the
    reference's (op by op). The jitted reference multiplies by
    ``f32(1/127)`` where the code divides by 127 (XLA's rewrite): the
    payload is the same, the scales within 1 ulp.
  * ``adamw_update`` (8-bit and f32 moments, 6 steps, each from the
    reference's state) against the jitted reference: new params within
    ``PARAM_ULPS`` = 2 ulps of each leaf's largest magnitude (measured 1;
    XLA contracts the moment updates into FMAs and sums the global norm
    in its own order, <= 1 ulp of the norm); int8 moments equal but at
    rounding ties (<= ``TIE_SHARE`` = 1e-3 of the entries; measured 1 of
    256,512), off by one level at most; f32 moments and the moments'
    scales within ``MOMENT_ULPS`` = 8 ulps of the leaf's largest
    (measured <= 5). The bias-correction powers ``b ** count`` differ
    from XLA's by 1 ulp at 180 (b1) and 40 (b2) of the counts 1-1,700, and
    XLA flushes subnormal results to 0; ``1 - b ** count``, what the update
    uses, differs at 1 count by <= 2 ulps.
  * ``compress_grads`` on the same f32 input: bit-identical to the
    reference op by op; against the jitted reference the payload equal
    but at ties, the scales within 1 ulp and the residuals within 2 ulps
    of the leaf's largest |g + r| (the reciprocal again).
  * Gradients of ``train_fwd`` (``synth_batch(cfg, 0, 2, 64)``, q/kv
    chunks 32), per leaf: max |port - ref| <= ``GRAD_TOL`` = 3e-2 *
    max |ref|, every gradient finite, a leaf the loss does not reach
    exactly 0 in both. Seven archs against the jitted reference (measured
    <= 2.4e-2, qwen2-vl's ``attn.bk``). The jitted reference disagrees
    with its own op-by-op run on phi3.5-moe and deepseek-v3 (phi3.5-moe's
    loss 6.777201 jitted, 6.769811 op by op, the port 6.769809) and on
    hymba (2.99e-2 jitted, 1.5e-2 op by op): XLA drops bf16 roundings
    there (ROADMAP.md, queue 3). Those three are held against the
    reference jitted with ``--xla_allow_excess_precision=false`` (every
    bf16 rounding kept, as op by op) in this file's one JAX subprocess:
    its loss is the op-by-op loss (6.769811) and its gradients give the
    op-by-op run's figures (phi3.5-moe 1.3e-2, deepseek-v3 2.5e-2, hymba
    1.5e-2), at ~5 s an arch instead of 24-55 s op by op.
  * One ``build_train_step`` step (8-bit, ``n_micro=2``, compress, lr
    1e-3, warmup 5, ``synth_batch(cfg, 0, 4, 64)``) on reduced mamba2
    (jitted reference) and reduced phi3.5-moe (the subprocess): loss within
    ``LOSS_TOL`` = 2e-3 of the reference's, ``grad_norm`` within
    ``NORM_TOL`` = 1e-2 (measured 5.5e-5 and 4.7e-4), ``lr`` equal. New
    params: the first Adam step moves an entry by about lr * g / |g|
    (zero where the compressed gradient is zero), so an entry whose
    compressed gradient's sign or zero-ness differs moves by up to 2 lr
    more; a gradient within 3e-2 of the leaf's scale can flip an int8
    level of the compression (a level is 1/127 of a block's largest).
    Every entry within 2.01 lr of the reference; at most ``FLIP_SHARE`` =
    2 % of the entries (of a leaf, or 1 entry) more than lr / 2 away
    (measured 0.67 % and 0.34 % overall, 1 of 16 in the smallest leaves);
    the mean |difference| <= ``MEAN_STEP_TOL`` = 2e-2 lr (measured 6.8e-3
    and 3.4e-3).
  * Checkpoints: written by either package, restored by the other, every
    leaf bit for bit, same names, shapes, dtypes and manifest.

The JAX subprocess takes ~25 s and runs beside the in-process cases; the
file takes ~75 s on one thread.
"""

import functools
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import checkpoint as JC
from repro.models import archs as jax_archs
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training import train_step as JTS
from repro_torch.data.pipeline import Prefetcher, host_slice, synth_batch
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.launch import train as train_cli
from repro_torch.launch import train_lm
from repro_torch.models import model as M
from repro_torch.models.archs import ARCHS, get_arch, reduced_config
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from repro_torch.training import tree as T

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
NAMES = sorted(ARCHS)
KEPT = ("deepseek-v3-671b", "hymba-1.5b", "phi3.5-moe-42b-a6.6b")
STEP_ARCHS = ("mamba2-130m", "phi3.5-moe-42b-a6.6b")
GRAD_TOL = 3e-2
LOSS_TOL = 2e-3
NORM_TOL = 1e-2
PARAM_ULPS = 2
MOMENT_ULPS = 8
TIE_SHARE = 1e-3
FLIP_SHARE = 2e-2
MEAN_STEP_TOL = 2e-2
STEP_ADAM = dict(lr=1e-3, warmup=5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: small CPU ops run ~100x slower on many
    threads here (they contend for cores with the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tt(batch) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jj(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _flat_np(tree) -> dict:
    """{'a/b': numpy} of a tree of either package, in the reference's
    order."""
    return {"/".join(map(str, p)): (v.numpy() if isinstance(v, torch.Tensor)
                                     else np.asarray(v))
            for p, v in T.flatten_with_path(tree)}


def _params(name: str):
    cfg = reduced_config(get_arch(name))
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")


def _ulps(a, b, scale) -> float:
    """max |a - b| in ulps of ``scale`` (a leaf's largest magnitude)."""
    sp = np.spacing(np.float32(max(float(scale), 1e-30)))
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max() / sp)


# ---------------------------------------------------------------------------
# the file's one JAX subprocess: every bf16 rounding kept
# ---------------------------------------------------------------------------

_SUBPROCESS = r"""
import functools, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.models import model as JM
from repro.models.archs import get_arch, reduced_config
from repro.training import optimizer as JO
from repro.training import train_step as JTS

d = sys.argv[1]
names, step_arch = sys.argv[2].split(","), sys.argv[3]
adam = JO.AdamWConfig(lr=float(sys.argv[4]), warmup=int(sys.argv[5]))


def tree(npz, prefix):
    out = {}
    for k in npz.files:
        if k.startswith(prefix):
            node = out
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(npz[k])
    return out


def flat(t, prefix, out):
    for path, v in jax.tree_util.tree_flatten_with_path(t)[0]:
        out[prefix + "/".join(str(p.key) for p in path)] = np.asarray(v)


for name in names:
    cfg = reduced_config(get_arch(name))
    npz = np.load(f"{d}/{name}.npz")
    params, batch = tree(npz, "p/"), tree(npz, "b/")
    out = {}
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        JM.train_fwd, cfg=cfg, q_chunk=32, kv_chunk=32)))(params, batch)
    out["loss"] = np.asarray(loss)
    flat(grads, "g/", out)
    if name == step_arch:
        sb = tree(npz, "s/")
        step = jax.jit(JTS.build_train_step(cfg, adam, n_micro=2,
                                            compress=True, q_chunk=32,
                                            kv_chunk=32))
        p2, _, m, _ = step(params, JO.adamw_init(params, adam), sb,
                           JO.compress_init(params))
        for k in ("loss", "grad_norm", "lr"):
            out["m/" + k] = np.asarray(m[k])
        flat(p2, "n/", out)
    np.savez(f"{d}/{name}.out.npz", **out)
print("done", flush=True)
"""


class _KeptReference:
    """Starts the JAX subprocess on first use; ``get(name)`` waits for it
    and returns that arch's outputs."""

    def __init__(self, d: Path):
        self.d = d
        for name in KEPT:
            cfg, params = _params(name)
            arrays = {"p/" + k: v for k, v in _flat_np(params).items()}
            arrays.update({"b/" + k: v for k, v in
                           synth_batch(cfg, 0, 2, 64).items()})
            arrays.update({"s/" + k: v for k, v in
                           synth_batch(cfg, 0, 4, 64).items()})
            np.savez(d / f"{name}.npz", **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_allow_excess_precision=false",
                   PYTHONPATH=str(ROOT / "src"))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _SUBPROCESS, str(d), ",".join(KEPT),
             STEP_ARCHS[1], str(STEP_ADAM["lr"]), str(STEP_ADAM["warmup"])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        self._out = None

    def get(self, name: str) -> dict:
        if self._out is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-3000:]
            self._out = {n: dict(np.load(self.d / f"{n}.out.npz"))
                         for n in KEPT}
        return self._out[name]


@pytest.fixture(scope="module")
def kept_ref(tmp_path_factory):
    ref = _KeptReference(tmp_path_factory.mktemp("kept_ref"))
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.communicate()


# ---------------------------------------------------------------------------
# mirrors of tests/test_system.py
# ---------------------------------------------------------------------------


def test_synth_batch_deterministic():
    cfg = reduced_config(get_arch("yi-34b"))
    a = synth_batch(cfg, step=5, batch=4, seq=32)
    b = synth_batch(cfg, step=5, batch=4, seq=32)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = synth_batch(cfg, step=6, batch=4, seq=32)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_tokens_are_shifted_labels():
    cfg = reduced_config(get_arch("yi-34b"))
    b = synth_batch(cfg, 0, 2, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_prefetcher_orders_steps():
    cfg = reduced_config(get_arch("mamba2-130m"))
    pf = Prefetcher(cfg, batch=2, seq=32, start_step=3)
    try:
        for step in (3, 4, 5, 6):
            b = pf.next()
            np.testing.assert_array_equal(
                b["tokens"], synth_batch(cfg, step, 2, 32)["tokens"])
    finally:
        pf.close()


def test_prefetcher_raises_the_workers_error():
    """An exception while making a batch reaches ``next()``; it does not
    hang it."""
    cfg = reduced_config(get_arch("mamba2-130m"))
    pf = Prefetcher(cfg, batch=-1, seq=32)
    result = {}

    def call():
        with pytest.raises(ValueError) as err:
            pf.next()
        result["err"] = err

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(timeout=30)
    pf.close()
    assert not t.is_alive(), "Prefetcher.next() hung on a worker error"
    assert "err" in result


def test_host_slice_partitions():
    rows = [host_slice(256, h, 16) for h in range(16)]
    assert rows[0] == (0, 16) and rows[15] == (240, 256)
    covered = sum(b - a for a, b in rows)
    assert covered == 256


def test_train_step_reduces_loss():
    cfg = reduced_config(get_arch("mamba2-130m"))
    adam = opt.AdamWConfig(lr=1e-3, warmup=5)
    params, state, _ = ts.init_train_state(
        cfg, torch.Generator().manual_seed(0), adam, device="cpu")
    step = ts.build_train_step(cfg, adam, n_micro=2, q_chunk=32, kv_chunk=32)
    batch = _tt(synth_batch(cfg, 0, 4, 64))
    losses = []
    for _ in range(30):                 # same batch: loss must fall
        params, state, m, _ = step(params, state, batch, None)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, (losses[0], losses[-1])


def test_microbatch_equals_full_batch_grads():
    """n_micro=2 must give the same update as n_micro=1 (linearity)."""
    cfg = reduced_config(get_arch("mamba2-130m"))
    adam = opt.AdamWConfig(lr=1e-3, warmup=1, eightbit=False)
    params, state, _ = ts.init_train_state(
        cfg, torch.Generator().manual_seed(0), adam, device="cpu")
    batch = _tt(synth_batch(cfg, 0, 4, 32))
    s1 = ts.build_train_step(cfg, adam, n_micro=1, q_chunk=32, kv_chunk=32)
    s2 = ts.build_train_step(cfg, adam, n_micro=2, q_chunk=32, kv_chunk=32)
    p1, _, m1, _ = s1(params, state, batch, None)
    p2, _, m2, _ = s2(params, state, batch, None)
    # bf16 forward: small numeric drift allowed
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-2)
    d = [float(torch.max(torch.abs(a - b)))
         for a, b in zip(T.leaves(p1), T.leaves(p2))]
    assert max(d) < 2e-2


def test_train_step_leaves_its_inputs_and_returns_metrics():
    """The step is pure (the reference's jitted function): params, state
    and residual come back as new trees, the old ones untouched."""
    cfg = reduced_config(get_arch("mamba2-130m"))
    adam = opt.AdamWConfig(**STEP_ADAM)
    params, state, residual = ts.init_train_state(
        cfg, torch.Generator().manual_seed(0), adam, compress=True,
        device="cpu")
    before = [t.clone() for t in T.leaves((params, state, residual))]
    step = ts.build_train_step(cfg, adam, n_micro=2, compress=True,
                               q_chunk=32, kv_chunk=32)
    p2, s2, m, r2 = step(params, state, _tt(synth_batch(cfg, 0, 4, 32)),
                         residual)
    for a, b in zip(before, T.leaves((params, state, residual))):
        assert torch.equal(a, b)
    assert set(m) == {"loss", "grad_norm", "lr"}
    assert all(v.shape == () and v.dtype == torch.float32 for v in m.values())
    assert int(s2["count"]) == 1 and s2["count"].dtype == torch.int32
    assert float(torch.abs(T.leaves(r2)[0]).max()) > 0


def test_remat_changes_no_gradient():
    """``remat=True`` (each layer recomputed in the backward) gives the
    gradients of ``remat=False`` bit for bit."""
    cfg, params = _params("hymba-1.5b")
    batch = _tt(synth_batch(cfg, 0, 2, 32))
    grads = {}
    for remat in (True, False):
        leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
        loss = M.train_fwd(T.unflatten(params, leaves), batch, cfg,
                           q_chunk=32, kv_chunk=32, remat=remat)
        grads[remat] = torch.autograd.grad(loss, leaves, allow_unused=True)
    for a, b in zip(grads[True], grads[False]):
        assert (a is None and b is None) or torch.equal(a, b)


# ---------------------------------------------------------------------------
# mirrors of tests/test_distributed.py: checkpoint and optimizer
# ---------------------------------------------------------------------------


@pytest.fixture
def tree():
    g = torch.Generator().manual_seed(0)
    return {"layers": {"w": torch.randn((8, 16), generator=g),
                       "b": torch.zeros((16,))},
            "step_count": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tree, tmp_path):
    d = str(tmp_path)
    ckpt.save(tree, d, step=10)
    restored, step = ckpt.restore(tree, d, shardings=CPU)
    assert step == 10
    for a, b in zip(T.leaves(tree), T.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_latest_pointer_and_gc(tree, tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tree, d, step=s, keep=2)
    assert ckpt.latest_step(d) == 5
    kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]   # keep-last-k GC
    assert not any(x.endswith(".tmp") for x in os.listdir(d))


def test_checkpoint_async(tree, tmp_path):
    d = str(tmp_path)
    saver = ckpt.AsyncCheckpointer(d)
    saver.save(tree, 42)
    saver.wait()
    _, step = ckpt.restore(tree, d, shardings=CPU)
    assert step == 42


def test_checkpoint_async_error_reaches_wait(tree, tmp_path):
    """A save that fails on the worker thread is raised by ``wait()``,
    once."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    saver = ckpt.AsyncCheckpointer(str(blocker))
    saver.save(tree, 1)
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()


def test_checkpoint_shape_mismatch_rejected(tree, tmp_path):
    d = str(tmp_path)
    ckpt.save(tree, d, step=1)
    bad = dict(tree)
    bad["layers"] = {"w": torch.zeros((4, 4)), "b": tree["layers"]["b"]}
    with pytest.raises(AssertionError):
        ckpt.restore(bad, d, shardings=CPU)


def test_checkpoint_restore_placement(tree, tmp_path):
    """``shardings``: one device for every leaf, or a tree of devices."""
    d = str(tmp_path)
    ckpt.save(tree, d, step=3)
    per_leaf = T.tree_map(lambda _: CPU, tree)
    for shardings in ("cpu", CPU, per_leaf):
        restored, _ = ckpt.restore(tree, d, shardings=shardings)
        assert all(t.device == CPU for t in T.leaves(restored))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tree, str(tmp_path / "empty"), shardings=CPU)


def test_adamw_8bit_tracks_fp32():
    """8-bit-moment AdamW must track the fp32 optimizer closely."""
    g = torch.Generator().manual_seed(1)
    params = {"w": torch.randn((64, 64), generator=g) * 0.1}
    cfg8 = opt.AdamWConfig(lr=1e-2, warmup=1, eightbit=True,
                           weight_decay=0.0)
    cfg32 = opt.AdamWConfig(lr=1e-2, warmup=1, eightbit=False,
                            weight_decay=0.0)
    s8, s32 = opt.adamw_init(params, cfg8), opt.adamw_init(params, cfg32)
    p8 = p32 = params
    for i in range(5):
        gi = {"w": torch.randn((64, 64),
                               generator=torch.Generator().manual_seed(i))}
        p8, s8, _ = opt.adamw_update(p8, gi, s8, cfg8)
        p32, s32, _ = opt.adamw_update(p32, gi, s32, cfg32)
    diff = float(torch.max(torch.abs(p8["w"] - p32["w"])))
    scale = float(torch.max(torch.abs(p32["w"] - params["w"])))
    # 8-bit moments track within a fraction of the total update magnitude
    assert diff < 0.25 * scale, (diff, scale)


def test_grad_compression_error_feedback():
    """int8-compressed grads with error feedback: the *accumulated* applied
    gradient converges to the true accumulated gradient."""
    g = {"w": torch.as_tensor(np.random.default_rng(0)
                              .standard_normal((32, 32)), dtype=torch.float32)}
    residual = opt.compress_init(g)
    applied = torch.zeros((32, 32))
    for _ in range(20):
        comp, residual = opt.compress_grads(g, residual)
        deq = opt.decompress_grads(comp, g)
        applied = applied + deq["w"]
    true = 20 * g["w"]
    rel = float(torch.max(torch.abs(applied - true)) / torch.max(
        torch.abs(true)))
    assert rel < 0.02, rel           # error feedback keeps long-run bias ~0


def test_q8_roundtrip_bound():
    x = torch.as_tensor(np.random.default_rng(3)
                        .standard_normal(1000) * 5, dtype=torch.float32)
    q, s = opt._q8(x)
    back = opt._dq8(q, s, x.shape)
    blockmax = torch.max(torch.abs(x))
    err = float(torch.max(torch.abs(back - x)))
    assert err <= float(blockmax) / 127 + 1e-6


# ---------------------------------------------------------------------------
# parity: the optimizer
# ---------------------------------------------------------------------------

Q8_CASES = [((1000,), 5.0), ((64, 64), 1.0), ((3, 7, 130), 1e-3),
            ((1,), 50.0), ((128,), 0.0)]


@pytest.mark.parametrize("shape,scale", Q8_CASES, ids=str)
def test_q8_bit_identical_to_reference(shape, scale):
    x = (np.random.default_rng(len(shape)).standard_normal(shape)
         * scale).astype(np.float32)
    if shape == (128,):         # scale 1.0: a rounding tie at every .5
        x = np.concatenate([[127.0], np.arange(127) - 62.5]).astype(
            np.float32)
    q, s = opt._q8(torch.from_numpy(x))
    jq, js = JO._q8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    back = opt._dq8(q, s, x.shape).numpy()
    np.testing.assert_array_equal(
        back.view(np.uint32),
        np.asarray(JO._dq8(jq, js, x.shape)).view(np.uint32))
    # jitted: XLA multiplies by f32(1/127); the payload is the same
    kq, ks = jax.jit(JO._q8)(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(kq))
    assert np.abs(s.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(ks).view(np.int32)).max() <= 1


@pytest.mark.parametrize("eightbit", [True, False], ids=["8bit", "f32"])
def test_adamw_update_matches_reference(eightbit):
    rng = np.random.default_rng(7)
    shapes = {"w": (64, 300), "b": {"z": (77,)}, "e": (3, 5, 130)}
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s) * 0.1).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    jcfg = JO.AdamWConfig(lr=1e-2, warmup=3, eightbit=eightbit)
    pcfg = opt.AdamWConfig(lr=1e-2, warmup=3, eightbit=eightbit)
    update = jax.jit(functools.partial(JO.adamw_update, cfg=jcfg))
    jp = jax.tree.map(jnp.asarray, params)
    js = JO.adamw_init(jp, jcfg)
    to_t = functools.partial(jax.tree.map,
                             lambda a: torch.from_numpy(np.array(a)))
    ties = entries = 0
    for _ in range(6):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
            np.float32), params)
        tp, tstate, tm = opt.adamw_update(to_t(jp), to_t(g), to_t(js), pcfg)
        jp, js, jm = update(jp, jax.tree.map(jnp.asarray, g), js)
        assert float(tm["lr"]) == float(jm["lr"])
        assert _ulps(tm["grad_norm"], jm["grad_norm"], jm["grad_norm"]) <= 1
        assert int(tstate["count"]) == int(js["count"])
        new = _flat_np(tp)
        for k, ref in _flat_np(jp).items():
            assert _ulps(new[k], ref, np.abs(ref).max()) <= PARAM_ULPS, k
        for mom in ("m", "v"):
            port, ref = _flat_np(tstate[mom]), _flat_np(js[mom])
            assert port.keys() == ref.keys()
            for k, r in ref.items():
                if k.endswith("/q"):
                    ties += int((port[k] != r).sum())
                    entries += r.size
                    assert np.abs(port[k].astype(int) - r).max() <= 1, k
                else:
                    assert _ulps(port[k], r, np.abs(r).max()) <= MOMENT_ULPS
    if eightbit:
        assert ties <= TIE_SHARE * entries, (ties, entries)


def test_bias_correction_powers_match_xla():
    """``b ** count`` within 1 ulp of XLA's where XLA's is normal (below
    that XLA flushes to 0 and the port's is subnormal); ``1 - b ** count``,
    what the update uses, within 2 ulps at <= 1 count of 1,700."""
    c = np.arange(1, 1701, dtype=np.float32)
    tiny = np.finfo(np.float32).tiny
    for b in (0.9, 0.95):
        port = (b ** torch.from_numpy(c)).numpy()
        ref = np.asarray(jax.jit(lambda x, b=b: b ** x)(jnp.asarray(c)))
        normal = ref >= tiny
        assert np.abs(port.view(np.int32)[normal].astype(np.int64)
                      - ref.view(np.int32)[normal]).max() <= 1
        assert (ref[~normal] == 0).all() and (port[~normal] < tiny).all()
        port1 = (1.0 - b ** torch.from_numpy(c)).numpy()
        ref1 = np.asarray(jax.jit(lambda x, b=b: 1.0 - b ** x)(
            jnp.asarray(c)))
        assert (port1 != ref1).sum() <= 1
        assert np.abs(port1.view(np.int32).astype(np.int64)
                      - ref1.view(np.int32)).max() <= 2


@pytest.mark.parametrize("jit", [False, True], ids=["op_by_op", "jitted"])
def test_compress_grads_matches_reference(jit):
    """Op by op: payload, scales and residuals bit-identical. Jitted (XLA
    multiplies by f32(1/127)): payload equal but at ties, scales within 1
    ulp, residuals within 2 ulps of the leaf's largest |g + r|."""
    rng = np.random.default_rng(11)
    g = {"a": rng.standard_normal((40, 50)).astype(np.float32),
         "b": {"c": (rng.standard_normal(300) * 1e-3).astype(np.float32)}}
    r = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-3)
                     .astype(np.float32), g)
    to_t = functools.partial(jax.tree.map, torch.from_numpy)
    comp, res = opt.compress_grads(to_t(g), to_t(r))
    fn = jax.jit(JO.compress_grads) if jit else JO.compress_grads
    jcomp, jres = fn(jax.tree.map(jnp.asarray, g),
                     jax.tree.map(jnp.asarray, r))
    pc, rc = _flat_np(comp), _flat_np(jcomp)
    assert pc.keys() == rc.keys()
    pr, rr = _flat_np(res), _flat_np(jres)
    back = _flat_np(opt.decompress_grads(comp, to_t(g)))
    jback = _flat_np(JO.decompress_grads(jcomp, g))
    if not jit:
        for port, ref in ((pc, rc), (pr, rr), (back, jback)):
            for k, v in ref.items():
                assert port[k].dtype == v.dtype and port[k].shape == v.shape
                assert port[k].tobytes() == v.tobytes(), k
        return
    total = {k: np.abs(g_ + r_).max() for k, g_, r_ in zip(
        _flat_np(g), _flat_np(g).values(), _flat_np(r).values())}
    for k, ref in rc.items():
        if k.endswith("/q"):
            assert (pc[k] != ref).sum() <= TIE_SHARE * ref.size + 1
        else:
            assert _ulps(pc[k], ref, np.abs(ref).max()) <= 1, k
    for k, ref in rr.items():
        assert _ulps(pr[k], ref, total[k]) <= 2, k
        assert back[k].shape == jback[k].shape


# ---------------------------------------------------------------------------
# parity: gradients of the 10 reduced archs, one train step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _port_grads(name: str):
    cfg, params = _params(name)
    loss, grads = ts.value_and_grad(params, _tt(synth_batch(cfg, 0, 2, 64)),
                                    cfg, q_chunk=32, kv_chunk=32)
    return float(loss), _flat_np(grads)


def _ref_grads(name: str, kept_ref):
    if name in KEPT:
        out = kept_ref.get(name)
        return float(out["loss"]), {k[2:]: v for k, v in out.items()
                                    if k.startswith("g/")}
    cfg, params = _params(name)
    jcfg = jax_archs.reduced_config(jax_archs.get_arch(name))
    jp = jax.tree.map(jnp.asarray, M.tree_map(lambda t: t.numpy(), params))
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        JM.train_fwd, cfg=jcfg, q_chunk=32, kv_chunk=32)))(
            jp, _jj(synth_batch(cfg, 0, 2, 64)))
    return float(loss), _flat_np(grads)


@pytest.fixture(scope="module")
def grads(kept_ref):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (_port_grads(name), _ref_grads(name, kept_ref))
        return cache[name]
    return get


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_reference(grads, name):
    (loss, port), (ref_loss, ref) = grads(name)
    assert port.keys() == ref.keys()
    worst = 0.0
    for k, r in ref.items():
        g = port[k]
        assert g.shape == r.shape and g.dtype == np.float32, k
        assert np.isfinite(g).all(), k
        scale = np.abs(r).max()
        if scale == 0:                  # a leaf the loss does not reach
            assert not np.any(g), k
            continue
        rel = float(np.abs(g - r).max() / scale)
        worst = max(worst, rel)
        assert rel <= GRAD_TOL, (k, rel)
    print(f"{name}: worst leaf {worst:.4f} of max |ref|")


@pytest.mark.parametrize("name", NAMES)
def test_train_loss_with_grad_matches_reference(grads, name):
    (loss, _), (ref_loss, _) = grads(name)
    assert abs(loss - ref_loss) <= LOSS_TOL * abs(ref_loss), (loss, ref_loss)


@functools.lru_cache(maxsize=None)
def _port_step(name: str):
    cfg, params = _params(name)
    adam = opt.AdamWConfig(**STEP_ADAM)
    step = ts.build_train_step(cfg, adam, n_micro=2, compress=True,
                               q_chunk=32, kv_chunk=32)
    p2, s2, m, r2 = step(params, opt.adamw_init(params, adam),
                         _tt(synth_batch(cfg, 0, 4, 64)),
                         opt.compress_init(params))
    return ({k: float(v) for k, v in m.items()}, _flat_np(p2),
            _flat_np(params))


def _ref_step(name: str, kept_ref):
    if name in KEPT:
        out = kept_ref.get(name)
        return ({k[2:]: float(v) for k, v in out.items()
                 if k.startswith("m/")},
                {k[2:]: v for k, v in out.items() if k.startswith("n/")})
    cfg, params = _params(name)
    jcfg = jax_archs.reduced_config(jax_archs.get_arch(name))
    adam = JO.AdamWConfig(**STEP_ADAM)
    jp = jax.tree.map(jnp.asarray, M.tree_map(lambda t: t.numpy(), params))
    step = jax.jit(JTS.build_train_step(jcfg, adam, n_micro=2, compress=True,
                                        q_chunk=32, kv_chunk=32))
    p2, _, m, _ = step(jp, JO.adamw_init(jp, adam),
                       _jj(synth_batch(cfg, 0, 4, 64)),
                       JO.compress_init(jp))
    return {k: float(v) for k, v in m.items()}, _flat_np(p2)


@pytest.fixture(scope="module")
def steps(kept_ref):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (_port_step(name), _ref_step(name, kept_ref))
        return cache[name]
    return get


@pytest.mark.parametrize("name", STEP_ARCHS)
def test_train_step_metrics_match_reference(steps, name):
    (m, _, _), (rm, _) = steps(name)
    assert abs(m["loss"] - rm["loss"]) <= LOSS_TOL * abs(rm["loss"])
    assert abs(m["grad_norm"] - rm["grad_norm"]) <= NORM_TOL * rm["grad_norm"]
    assert m["lr"] == rm["lr"]


@pytest.mark.parametrize("name", STEP_ARCHS)
def test_train_step_params_match_reference(steps, name):
    (m, new, old), (rm, ref) = steps(name)
    assert new.keys() == ref.keys()
    lr = rm["lr"]
    moved = entries = 0
    total = 0.0
    for k, r in ref.items():
        assert np.isfinite(new[k]).all(), k
        d = np.abs(new[k].astype(np.float64) - r)
        assert d.max() <= 2.01 * lr, (k, d.max() / lr)
        n = int((d > lr / 2).sum())        # a step's sign or zero-ness
        assert n <= max(1, FLIP_SHARE * r.size), (k, n, r.size)
        moved += n
        entries += r.size
        total += float(d.sum())
    assert moved <= FLIP_SHARE * entries, (moved, entries)
    assert total / entries <= MEAN_STEP_TOL * lr, total / entries / lr
    print(f"{name}: {moved} of {entries} entries moved differently "
          f"({moved / entries:.2e}); mean |diff| {total / entries / lr:.4f}"
          f" lr")


# ---------------------------------------------------------------------------
# parity: checkpoints across the two packages
# ---------------------------------------------------------------------------


def _state_trees():
    """The same (params, AdamW state) in both packages: reduced mamba2,
    one 8-bit step taken so the moments are not zero."""
    cfg, params = _params("mamba2-130m")
    adam = opt.AdamWConfig(**STEP_ADAM)
    g = T.tree_map(lambda p: torch.randn(
        p.shape, generator=torch.Generator().manual_seed(p.numel())), params)
    p2, s2, _ = opt.adamw_update(params, g, opt.adamw_init(params, adam),
                                 adam)
    port = (p2, s2)
    ref = jax.tree.map(lambda t: jnp.asarray(t.numpy()), port)
    return port, ref


def _assert_same_leaves(port_tree, ref_tree):
    port, ref = _flat_np(port_tree), _flat_np(ref_tree)
    assert list(port) == list(ref)
    for k, r in ref.items():
        assert port[k].dtype == r.dtype and port[k].shape == r.shape, k
        assert port[k].tobytes() == r.tobytes(), k


def test_reference_checkpoint_restores_in_port(tmp_path):
    port, ref = _state_trees()
    JC.save(ref, str(tmp_path), step=5)
    restored, step = ckpt.restore(port, str(tmp_path), shardings=CPU)
    assert step == 5 and isinstance(restored, tuple)
    _assert_same_leaves(restored, ref)
    assert restored[1]["count"].dtype == torch.int32
    assert restored[1]["m"]["embed"]["tok"]["q"].dtype == torch.int8


def test_port_checkpoint_restores_in_reference(tmp_path):
    port, ref = _state_trees()
    ckpt.save(port, str(tmp_path), step=6)
    restored, step = JC.restore(ref, str(tmp_path))
    assert step == 6
    _assert_same_leaves(port, restored)


def test_checkpoint_files_match_reference(tmp_path):
    """Same directory layout, manifest and npz member names, in order."""
    port, ref = _state_trees()
    ckpt.save(port, str(tmp_path / "port"), step=7)
    JC.save(ref, str(tmp_path / "ref"), step=7)
    for side in ("port", "ref"):
        assert sorted(os.listdir(tmp_path / side)) == ["LATEST",
                                                       "step_00000007"]
        assert (tmp_path / side / "LATEST").read_text() == "7"
    a, b = (tmp_path / s / "step_00000007" for s in ("port", "ref"))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    assert json.loads((a / "manifest.json").read_text()) == json.loads(
        (b / "manifest.json").read_text())
    assert np.load(a / "host0.npz").files == np.load(b / "host0.npz").files


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_launch_train_runs_and_resumes(tmp_path, capsys):
    """``launch.train.main`` on the CPU: 4 steps, then a resume to 7 in
    the same directory == 7 steps straight through, loss for loss (the
    two runs' warmups agree: steps // 10 + 1 == 1)."""
    d, straight = str(tmp_path / "a"), str(tmp_path / "b")
    common = ["--smoke", "--batch", "4", "--seq", "32", "--micro", "2",
              "--lr", "1e-3", "--device", "cpu", "--log-every", "1"]
    first = train_cli.main(common + ["--steps", "4", "--ckpt-dir", d])
    assert len(first) == 4 and all(np.isfinite(first))
    assert ckpt.latest_step(d) == 4
    resumed = train_cli.main(common + ["--steps", "7", "--ckpt-dir", d,
                                       "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "final loss" in out
    assert ckpt.latest_step(d) == 7
    whole = train_cli.main(common + ["--steps", "7", "--ckpt-dir",
                                     straight])
    assert first + resumed == whole
    a = np.load(os.path.join(d, "step_00000007", "host0.npz"))
    b = np.load(os.path.join(straight, "step_00000007", "host0.npz"))
    assert a.files == b.files
    assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)


def test_launch_train_compress_micro_checkpoints(tmp_path):
    d = str(tmp_path)
    losses = train_cli.main(["--smoke", "--steps", "3", "--batch", "4",
                             "--seq", "32", "--micro", "2", "--compress",
                             "--ckpt-every", "1", "--ckpt-dir", d,
                             "--device", "cpu"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert kept == ["step_00000001", "step_00000002", "step_00000003"]


def test_train_lm_short_run(tmp_path, capsys, monkeypatch):
    """The example's argv (mamba2-130m, micro 2, compress, a checkpoint
    every 100 steps), on a reduced config: ``get_arch`` is patched so the
    CPU can run it."""
    monkeypatch.setattr(train_cli, "get_arch",
                        lambda name: reduced_config(get_arch(name)))
    losses = train_lm.main(["--steps", "2", "--batch", "2", "--seq", "32",
                            "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert len(losses) == 2
    out = capsys.readouterr().out
    assert "arch=mamba2-130m-smoke" in out and "OK — short sanity run" in out
