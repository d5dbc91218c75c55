"""The port's serving path against the JAX package: the serving engine,
the synthetic data pipeline, the serve launcher and the private-inference
loop (paper Fig. 1).

  * ``ServingEngine``: the two cases of ``tests/test_serving.py`` on the
    port, and the port engine's tokens equal to the JAX engine's for the
    same requests and weights (JAX weights carried through
    ``params_from_numpy``);
  * ``synth_batch`` / ``host_slice``: equal word for word;
  * ``python -m repro_torch.launch.serve --smoke --device cpu``;
  * the private-inference loop at ``reduced_config('qwen2-vl-2b')`` with
    ``FHEClient('tiny')``, through the service and ``--direct``: the input
    ciphertexts bit-identical to the JAX client's for the same seed and
    nonce (the service's wire payload byte for byte), the served output
    within 3e-2 * max |ref| + 2^-15 of the JAX stand-in server's on the
    same decrypted inputs (the bf16 logits' tolerance of
    ``test_torch_models.py``, then the CKKS round trip), and the input
    round trip < 1e-4 (the reference's assert).
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jax_pipeline
from repro.fhe_client.client import FHEClient as JaxClient
from repro.fhe_client.service import wire as jax_wire
from repro.models import archs as jax_archs
from repro.models import model as JM
from repro.serving import engine as jax_engine
from repro_torch.data.pipeline import host_slice, synth_batch
from repro_torch.fhe_client import private_inference as pi
from repro_torch.fhe_client.client import FHEClient
from repro_torch.fhe_client.service import wire
from repro_torch.launch import serve as serve_mod
from repro_torch.models import model as M
from repro_torch.models.archs import get_arch, reduced_config
from repro_torch.serving.engine import Request, ServingEngine

SRC = Path(__file__).resolve().parents[1] / "src"
LOGIT_TOL = 3e-2
BATCH, SEQ = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: small CPU ops run ~100x slower on many
    threads here (they contend for cores with the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(jp):
    return M.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_arch("h2o-danube-3-4b"))
    jcfg = jax_archs.reduced_config(jax_archs.get_arch("h2o-danube-3-4b"))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jp, _carry(jp)


# ---------------------------------------------------------------------------
# the engine: mirrors of tests/test_serving.py, and the reference's tokens
# ---------------------------------------------------------------------------


def _requests(vocab: int, n: int, length: int, max_new: int, seed: int):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=rng.integers(0, vocab, length,
                                               dtype=np.int32),
                    max_new=max_new) for i in range(n)]


def test_engine_serves_more_requests_than_slots(setup):
    cfg, _, _, params = setup
    eng = ServingEngine(cfg, params, slots=2, cache_len=96, device="cpu")
    reqs = _requests(cfg.vocab, 5, 8, 4, 0)
    for r in reqs:
        eng.submit(r)
    done = eng.run(max_steps=64)
    assert len(done) == 5                 # slot reuse drained the queue
    for r in done:
        assert len(r.out) >= 4
        assert all(0 <= t < cfg.vocab for t in r.out)


def test_engine_greedy_matches_direct_decode(setup):
    """Single request through the engine == direct prefill+decode loop."""
    cfg, _, _, params = setup
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, 12,
                                               dtype=np.int32)
    eng = ServingEngine(cfg, params, slots=1, cache_len=64, device="cpu")
    req = Request(rid=0, tokens=prompt, max_new=4)
    eng.submit(req)
    eng.run(max_steps=16)

    lg, cache = M.prefill(params, {"tokens": torch.as_tensor(prompt)[None]},
                          cfg, cache_len=64, q_chunk=64, kv_chunk=64)
    toks = [int(torch.argmax(lg[0, -1, : cfg.vocab]))]
    pos = len(prompt)
    for _ in range(3):
        lg, cache = M.decode_step(params, cache,
                                  {"tokens": torch.tensor([[toks[-1]]])},
                                  pos, cfg)
        toks.append(int(torch.argmax(lg[0, -1, : cfg.vocab])))
        pos += 1
    assert req.out[:4] == toks


def _margins(logits, vocab: int) -> np.ndarray:
    """Top-1 minus top-2 logit, and the logits' scale, per row."""
    lg = np.asarray(logits[:, -1, :vocab].astype(jnp.float32))
    top = np.sort(lg, -1)
    return top[:, -1] - top[:, -2], np.abs(lg).max(-1)


def test_engine_tokens_match_reference(setup):
    """8 requests of mixed lengths over 3 slots (slot reuse; each step at
    the largest active position, as the reference steps) against the JAX
    engine. Each token must equal the reference's wherever the
    reference's top-2 margin exceeds LOGIT_TOL of its logits' scale; at a
    closer call a request is compared on only while the two agree (from a
    differing token on, the two decode different inputs)."""
    cfg, jcfg, jp, params = setup
    rng = np.random.default_rng(2)
    lengths = (8, 12, 8, 16, 12, 8, 16, 12)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in lengths]
    ref = jax_engine.ServingEngine(jcfg, jp, slots=3, cache_len=48)
    eng = ServingEngine(cfg, params, slots=3, cache_len=48, device="cpu")
    clear = {i: [] for i in range(len(prompts))}
    prefill, decode = ref._prefill, ref._decode
    order = iter(range(len(prompts)))

    def ref_prefill(*a):
        lg, cache = prefill(*a)
        m, scale = _margins(lg, cfg.vocab)
        clear[next(order)].append(bool(m[0] > LOGIT_TOL * scale[0]))
        return lg, cache

    def ref_decode(*a):
        rids = [r.rid if r else None for r in ref.active]
        lg, cache = decode(*a)
        m, scale = _margins(lg, cfg.vocab)
        for i, rid in enumerate(rids):
            if rid is not None:
                clear[rid].append(bool(m[i] > LOGIT_TOL * scale[i]))
        return lg, cache

    ref._prefill, ref._decode = ref_prefill, ref_decode
    for i, p in enumerate(prompts):
        ref.submit(jax_engine.Request(rid=i, tokens=p, max_new=6))
        eng.submit(Request(rid=i, tokens=p, max_new=6))
    want = {r.rid: r.out for r in ref.run(max_steps=64)}
    got = {r.rid: r.out for r in eng.run(max_steps=64)}
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    compared = 0
    for rid, toks in want.items():
        assert len(got[rid]) == len(toks) == len(clear[rid])
        for t_ref, t_got, ok in zip(toks, got[rid], clear[rid]):
            if ok:
                assert t_got == t_ref, (rid, toks, got[rid], clear[rid])
                compared += 1
            elif t_got != t_ref:
                break
    assert compared >= len(prompts) * 6 // 2


def test_engine_rejects_frontend_archs_and_foreign_params(setup):
    cfg, _, _, params = setup
    vl = reduced_config(get_arch("qwen2-vl-2b"))
    with pytest.raises(AssertionError, match="token-input"):
        ServingEngine(vl, params, device="cpu")
    meta = M.tree_map(lambda t: t.to("meta"), params)
    with pytest.raises(ValueError, match="params live on"):
        ServingEngine(cfg, meta, device="cpu")


def test_engine_cache_rows_are_per_slot(setup):
    """A slot's prefill writes only its own cache row."""
    cfg, _, _, params = setup
    eng = ServingEngine(cfg, params, slots=3, cache_len=32, device="cpu")
    eng._prefill_into_slot(1, Request(rid=0, tokens=np.arange(5,
                                                              dtype=np.int32)))
    k = eng.cache.k
    assert not k[:, 0].any() and not k[:, 2].any() and k[:, 1].any()
    assert list(eng.pos) == [0, 5, 0]


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen2-vl-2b", "musicgen-medium",
                                  "yi-34b", "mamba2-130m"])
def test_synth_batch_matches_reference(name):
    cfg = reduced_config(get_arch(name))
    jcfg = jax_archs.reduced_config(jax_archs.get_arch(name))
    for step, batch, seq, seed in ((0, 2, 16, 0), (7, 3, 5, 11)):
        got = synth_batch(cfg, step, batch, seq, seed)
        want = jax_pipeline.synth_batch(jcfg, step, batch, seq, seed)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for n in (1, 2, 4):
        for h in range(n):
            assert host_slice(64, h, n) == jax_pipeline.host_slice(64, h, n)


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------


def test_serve_smoke_on_cpu(capsys):
    toks, stats = serve_mod.main(["--smoke", "--device", "cpu", "--batch",
                                  "2", "--prompt-len", "32", "--gen", "6"])
    assert toks.shape == (2, 6)
    assert ((0 <= toks) & (toks < 512)).all()
    assert stats["prefill_s"] > 0 and stats["tok_per_s"] > 0
    assert "generated (2, 6) tokens" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["qwen2-vl-2b", "hymba-1.5b"])
def test_serve_is_deterministic_and_matches_direct(name):
    """serve() == its own prefill + greedy decode loop on the same params
    (a frontend arch decodes on zero embeds, as the reference does)."""
    cfg = reduced_config(get_arch(name))
    toks, _ = serve_mod.serve(cfg, 2, 16, 4, seed=3, device="cpu")
    again, _ = serve_mod.serve(cfg, 2, 16, 4, seed=3, device="cpu")
    np.testing.assert_array_equal(toks, again)
    params = M.init_params(cfg, torch.Generator().manual_seed(3),
                           device="cpu")
    data = {k: torch.as_tensor(v) for k, v in
            synth_batch(cfg, 0, 2, 16, 3).items() if k != "labels"}
    lg, cache = M.prefill(params, data, cfg, cache_len=20, q_chunk=16,
                          kv_chunk=16)
    out = [lg[:, -1, : cfg.vocab].argmax(-1)]
    for i in range(3):
        step = ({"embeds": torch.zeros((2, 1, cfg.d_model))} if cfg.frontend
                else {"tokens": out[-1][:, None]})
        lg, cache = M.decode_step(params, cache, step, 16 + i, cfg)
        out.append(lg[:, -1, : cfg.vocab].argmax(-1))
    np.testing.assert_array_equal(toks, torch.stack(out, 1).numpy())


def test_serve_module_runs_as_a_program():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-130m", "--smoke", "--device", "cpu", "--batch", "1",
         "--prompt-len", "8", "--gen", "3"], capture_output=True, text=True,
        timeout=300, env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                          "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "generated (1, 3) tokens" in proc.stdout


# ---------------------------------------------------------------------------
# the private-inference loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loop():
    """The reference side, once: JAX params of reduced qwen2-vl, the JAX
    client's input ciphertexts (fresh 'tiny' client, nonce 0) as wire
    bytes, and the JAX stand-in server."""
    cfg = reduced_config(get_arch("qwen2-vl-2b"))
    jcfg = jax_archs.reduced_config(jax_archs.get_arch("qwen2-vl-2b"))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal(
        (BATCH, SEQ * cfg.d_model)) * 0.1
    jclient = JaxClient(profile="tiny")
    ref_payload = jax_wire.serialize_ciphertext_batch(
        jclient.encode_encrypt_batch(jclient.pack(x)))
    prefill = jax.jit(functools.partial(JM.prefill, cfg=jcfg, cache_len=SEQ,
                                        q_chunk=16, kv_chunk=16))
    mrope = jnp.broadcast_to(jnp.arange(SEQ)[None, :, None],
                             (BATCH, SEQ, 3)).astype(jnp.int32)

    def jax_serve(x_rows):
        """The reference's stand-in server (secure_inference.py:157-166)."""
        embeds = jnp.asarray(x_rows.reshape(BATCH, SEQ, cfg.d_model),
                             jnp.float32)
        lg, _ = prefill(jp, {"embeds": embeds, "mrope_pos": mrope})
        out = np.asarray(lg.astype(jnp.float32))[:, 0, : cfg.d_model]
        return out.reshape(BATCH, cfg.d_model) / 10.0

    return cfg, _carry(jp), x, ref_payload, jax_serve


@pytest.mark.parametrize("direct", [False, True], ids=["service", "direct"])
def test_private_inference_matches_reference(loop, direct, monkeypatch):
    cfg, params, x, ref_payload, jax_serve = loop
    client = FHEClient("tiny", device="cpu")
    seen = {}
    served = []
    if direct:
        real_enc = client.encode_encrypt_batch

        def enc(msgs):
            cts = real_enc(msgs)
            seen.setdefault("payload", wire.serialize_ciphertext_batch(cts))
            return cts
        monkeypatch.setattr(client, "encode_encrypt_batch", enc)
    else:
        real_ser = wire.serialize_ciphertext_batch

        def ser(cts):
            out = real_ser(cts)
            seen.setdefault("payload", out)
            return out
        monkeypatch.setattr(wire, "serialize_ciphertext_batch", ser)
    serve_fn = pi.make_serve_fn(params, cfg, BATCH, SEQ, "cpu")

    def spy(x_rows):
        served.append(x_rows)
        return serve_fn(x_rows)

    if direct:
        y, stats = pi.simulate_private_inference(client, spy, x,
                                                 out_features=cfg.d_model)
    else:
        svc = pi.ClientService(client=client, buckets=(1, 2, 4, 8))
        y, stats = pi.simulate_private_inference_service(
            svc, spy, x, out_features=cfg.d_model)
        assert stats["upload_bytes"] == len(ref_payload)
        assert stats["download_bytes"] > 0
    assert seen["payload"] == ref_payload       # input ciphertexts, bitwise
    assert stats["roundtrip_err"] < pi.ROUNDTRIP_BOUND
    assert y.shape == (BATCH, cfg.d_model)
    ref = jax_serve(served[0])
    assert np.abs(y - ref).max() <= LOGIT_TOL * np.abs(ref).max() + 2 ** -15


@pytest.mark.parametrize("direct", [False, True], ids=["service", "direct"])
def test_private_inference_run_on_cpu(direct):
    cfg = reduced_config(get_arch("qwen2-vl-2b"))
    y, stats = pi.run(cfg, "tiny", direct=direct, device="cpu", seq=8)
    assert y.shape == (2, cfg.d_model) and np.isfinite(y).all()
    assert stats["roundtrip_err"] < pi.ROUNDTRIP_BOUND
    assert len(stats["serve_s"]) == 1 and stats["loop_s"] > 0
    if not direct:
        st = stats["service"]
        assert st["jobs_dispatched"] >= 4
        assert stats["upload_bytes"] > stats["download_bytes"] > 0


def test_private_inference_main_on_cpu(capsys):
    pi.main(["--device", "cpu", "--direct"])
    assert "OK — private-inference loop verified" in capsys.readouterr().out
