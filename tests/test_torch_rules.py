"""Rules of the port that no parity test would catch.

  * ``repro_torch`` imports neither ``jax`` nor any ``repro`` module: checked
    by importing every module in a subprocess where ``jax`` is poisoned, and
    by walking every module's AST;
  * the kernel build keeps the float code IEEE-exact (``--fmad=false``, no
    fast math);
  * the client runs on the card unless told otherwise (in both pipelines),
    rejects scales the df32 datapath cannot take exactly, and takes the
    reference's configurations (Fourier engine, pipeline, datapath) with
    the reference's rules: each selects its cores, each breach raises
    ``ValueError``; ``ops.fourier``'s host mode is the numpy oracle;
  * keys round-trip through ``keys_from_numpy``; the private-inference
    loop packs, encrypts, decrypts and unpacks activation rows;
  * the plain path (megakernel or staged, and the per-prime entry points
    of K12-K14) never touches a CUDA launch counter, and every CUDA wrapper
    refuses CPU tensors; ``ops.ntt_limbs`` refuses an unknown path;
  * no module of the port (the server evaluator ``fhe_server`` and the
    kernel modules included) holds a ``try`` statement, the shape a silent
    fall-back from a kernel to its plain version would take — except the
    client service's failure story: five handlers in
    ``fhe_client/service/{scheduler,runtime,service}.py`` (a launch that
    raises marks its stream dead and re-queues the job; a crashed loop
    thread is recorded; a failed materialize retries on a surviving
    stream), and the mesh's, in ``fhe_client/service/{mesh,worker}.py``
    (a worker's socket that fails marks it dead and re-sends its chunks to
    a survivor; a failed start-up kills the workers it started; a worker
    answers a failed chunk with an error frame), none of which calls a
    plain version or names the CPU;
  * the client service has no hidden device: ``stream_groups()``,
    ``ClientService()`` and ``MeshRouter()`` raise without CUDA, and a
    router given no device starts its workers on the card; nor has the LM
    substrate: ``init_params``, ``params_from_numpy``, ``ServingEngine``,
    ``serve``, ``private_inference.run`` and the two CLIs raise without
    CUDA unless given ``device='cpu'``;
  * the port's ``fhe_client.service`` exports the reference's names, and
    so do ``core`` and ``fhe_server``;
  * the ops-level server and stream entries, the kernel modules' routed
    entries under the reference's names and ``prng.cbd`` take the
    reference's positional parameters and defaults (read with ``ast``),
    but for the named deviations (Pallas-only parameters dropped, a
    ``device`` appended); ``MeshWorker.serve()`` takes no argument;
  * the names rule: every public function, class, method and module
    constant of each reference module has a same-named counterpart in the
    port's module of the same path (read with ``ast``, one case per
    module), but for 11 named deviations, each with its reason (Pallas
    block specs and interpret plumbing, jnp dtype aliases, jit-cache
    probes, an HLO-text parser);
  * the guards: every function of the reference that holds an ``assert``
    has, at the same path and qualified name in the port, at least as
    many (read with ``ast``; no allowed deviation), and on the same bad
    input the reference (JAX, in-process) and the port raise the same
    exception type. The reference's ``assert`` stays an ``assert``; the
    port's own device and generator checks raise ``ValueError``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.fhe_client.client import (FHEClient, keys_from_numpy,
                                           simulate_private_inference)
from repro_torch.kernels import (build, client_pointwise, client_stream,
                                 common, fft_df, ntt_butterfly, ntt_matmul,
                                 ops)

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
MODULES = sorted(PORT.rglob("*.py"))


def _module_name(path: Path) -> str:
    rel = path.relative_to(SRC).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: _module_name(p))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {name}"


def test_scans_cover_server_modules():
    names = {_module_name(p) for p in MODULES}
    assert {"repro_torch.fhe_server.eval_ops", "repro_torch.fhe_server.keys",
            "repro_torch.fhe_server.encrypted_inference",
            "repro_torch.kernels.server_eval"} <= names
    assert {"repro_torch.core.scheduler", "repro_torch.core.cache",
            "repro_torch.distributed.elastic",
            "repro_torch.distributed.sharding",
            "repro_torch.telemetry", "repro_torch.telemetry.metrics",
            "repro_torch.telemetry.tracing", "repro_torch.telemetry.probe",
            "repro_torch.fhe_client.tenancy",
            "repro_torch.fhe_client.service",
            "repro_torch.fhe_client.service.faults",
            "repro_torch.fhe_client.service.batcher",
            "repro_torch.fhe_client.service.scheduler",
            "repro_torch.fhe_client.service.runtime",
            "repro_torch.fhe_client.service.service",
            "repro_torch.fhe_client.service.mesh",
            "repro_torch.fhe_client.service.worker"} <= names


def test_scans_cover_lm_modules():
    """The LM substrate's modules are in the no-jax / no-try scans."""
    names = {_module_name(p) for p in MODULES}
    lm = {f"repro_torch.models.{m}" for m in (
        "config", "archs", "tuning", "layers", "mla", "moe", "ssm", "model")}
    lm |= {"repro_torch.configs.shapes", "repro_torch.data.pipeline",
           "repro_torch.serving.engine", "repro_torch.launch.serve",
           "repro_torch.fhe_client.private_inference"}
    lm |= {f"repro_torch.configs.{p.stem}"
           for p in (SRC / "repro" / "configs").glob("*.py")}
    assert lm <= names


def test_scans_cover_training_modules():
    """The training path's modules (every one of the reference's
    ``training/``, ``launch/train.py``, ``distributed/checkpoint.py``, the
    example ``train_lm`` and ``data/pipeline.py``) are in the no-jax /
    no-try scans; none of them holds a ``try``: the prefetcher and the
    async checkpointer hand their worker's error to the caller through a
    future, the launcher closes its prefetcher with ``with``."""
    names = {_module_name(p) for p in MODULES}
    training = {f"repro_torch.training.{p.stem}"
                for p in (SRC / "repro" / "training").glob("*.py")}
    assert training
    training |= {"repro_torch.launch.train", "repro_torch.launch.train_lm",
                 "repro_torch.distributed.checkpoint",
                 "repro_torch.data.pipeline"}
    assert training <= names
    for name in training:
        path = SRC.joinpath(*name.split(".")).with_suffix(".py")
        assert not _tries_by_function(path), name


def test_scans_cover_launch_modules():
    """The quickstart, the mesh descriptions, the specs and the dry-run
    are in the no-jax / no-try scans, and hold no ``try``."""
    names = {_module_name(p) for p in MODULES}
    launch = {f"repro_torch.launch.{m}" for m in (
        "quickstart", "mesh", "specs", "dryrun")}
    assert launch <= names
    for name in launch:
        path = SRC.joinpath(*name.split(".")).with_suffix(".py")
        assert not _tries_by_function(path), name


# The only ``try`` statements of the port: the client service's and the
# mesh's failure story, (file, enclosing function) -> handlers allowed
# there. A handler may re-queue, mark a stream or a worker failed, record,
# clean up or re-raise.
SERVICE_TRY = {
    ("fhe_client/service/scheduler.py", "dispatch"): 1,
    ("fhe_client/service/scheduler.py", "relaunch"): 1,
    ("fhe_client/service/runtime.py", "run"): 1,
    ("fhe_client/service/service.py", "_run_job"): 2,
    # a HELLO that never comes; a failed start-up kills its workers
    ("fhe_client/service/mesh.py", "_spawn_workers"): 2,
    # a dead worker's socket; a worker that will not exit is killed
    ("fhe_client/service/mesh.py", "close"): 2,
    # no survivor; a send that fails marks its worker dead
    ("fhe_client/service/mesh.py", "_send_chunk"): 3,
    ("fhe_client/service/mesh.py", "_pump"): 1,
    ("fhe_client/service/mesh.py", "_worker_died"): 1,
    # a malformed reply fails its chunk's requests
    ("fhe_client/service/mesh.py", "_handle_reply"): 1,
    ("fhe_client/service/mesh.py", "_service_conn"): 1,
    # a failed chunk is answered with an error frame
    ("fhe_client/service/worker.py", "serve"): 1,
    # the reader marks the end of the stream, however it ends
    ("fhe_client/service/worker.py", "_read_frames"): 1,
    ("fhe_client/service/worker.py", "main"): 1,
}
SERVICE_TRY_FILES = sorted({f for f, _fn in SERVICE_TRY})


def _tries_by_function(path: Path) -> dict:
    """{enclosing function name: [ast.Try, ...]} of one source file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out: dict = {}

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Try):
                out.setdefault(fn, []).append(child)
            visit(child, fn)

    visit(tree, None)
    return out


@pytest.mark.parametrize("path", MODULES, ids=lambda p: _module_name(p))
def test_no_try_statement_in_source(path):
    """No ``try`` anywhere in the port but the service's five handlers and
    the mesh's, each in the function the failure story puts it in."""
    rel = path.relative_to(PORT).as_posix()
    for fn, tries in _tries_by_function(path).items():
        allowed = SERVICE_TRY.get((rel, fn), 0)
        assert len(tries) <= allowed, \
            f"{path}:{tries[0].lineno} has a try statement (in {fn})"


@pytest.mark.parametrize("rel", SERVICE_TRY_FILES)
def test_service_try_handlers_never_fall_back(rel):
    """The service's and the mesh's handlers are the named ones and no
    handler body calls a ``*_plain`` function or mentions the CPU: a
    failure marks a stream or a worker dead, re-queues, records or
    re-raises — it never moves work to a plain version or to the host."""
    path = PORT / rel
    tries = _tries_by_function(path)
    assert {fn: len(t) for fn, t in tries.items()} == {
        fn: n for (f, fn), n in SERVICE_TRY.items() if f == rel}
    for node in (t for ts in tries.values() for t in ts):
        for handler in node.handlers:
            for sub in ast.walk(handler):
                if isinstance(sub, ast.Call):
                    f = sub.func
                    name = f.attr if isinstance(f, ast.Attribute) else \
                        getattr(f, "id", "")
                    assert not name.endswith("_plain"), \
                        f"{path}:{sub.lineno} calls {name} in a handler"
            text = ast.get_source_segment(path.read_text(), handler)
            assert "cpu" not in text.lower(), \
                f"{path}:{handler.lineno} mentions the CPU in a handler"
    assert sum(len(t) for t in tries.values()) <= sum(
        n for (f, _fn), n in SERVICE_TRY.items() if f == rel)


def test_service_entry_points_raise_without_cuda():
    """``stream_groups()`` defaults to every CUDA device and
    ``ClientService()`` builds its client on the card: without CUDA both
    raise, and CPU devices / a CPU client must be passed explicitly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.distributed.sharding import stream_groups
    from repro_torch.fhe_client.service import ClientService
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_groups()
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_groups(n_streams=2, oversubscribe=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClientService(profile="tiny")
    cpu = torch.device("cpu")
    assert stream_groups([cpu] * 2, 2) == [[cpu], [cpu]]
    svc = ClientService(FHEClient("tiny", device="cpu"), n_streams=2,
                        oversubscribe=True)
    assert [ex.devices for ex in svc.scheduler.streams] == [(cpu,), (cpu,)]
    assert all(ex.streams == (None,) for ex in svc.scheduler.streams)
    from repro_torch.fhe_client.service import MeshRouter
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshRouter(n_workers=1, profile="tiny")


def test_mesh_router_without_device_starts_workers_on_the_card(monkeypatch):
    """``MeshRouter()`` with no device passes ``--device cuda`` to every
    worker (never ``--device cpu``) and deserializes results onto the
    card; ``device='cpu'`` is the caller's explicit request. No worker is
    started here: the spawn is recorded, not run."""
    from repro_torch.fhe_client.service import MeshRouter
    cmds = []

    def spawn(self, n, faults, registry_capacity, timeout_s):
        cmds.extend(self._worker_cmd(wid, 1234, registry_capacity,
                                     faults.get(wid)) for wid in range(n))

    monkeypatch.setattr(MeshRouter, "_spawn_workers", spawn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    router = MeshRouter(n_workers=2, profile="tiny")
    assert router.device == torch.device("cuda")
    assert len(cmds) == 2
    for wid, cmd in enumerate(cmds):
        assert cmd[1:3] == ["-m", "repro_torch.fhe_client.service.worker"]
        assert cmd[cmd.index("--worker-id") + 1] == str(wid)
        assert cmd[cmd.index("--device") + 1] == "cuda"
        assert "cpu" not in cmd
    cmds.clear()
    router = MeshRouter(n_workers=1, profile="tiny", device="cpu")
    assert cmds[0][cmds[0].index("--device") + 1] == "cpu"


def _reference_all(path: Path) -> list:
    """The ``__all__`` list of a source file, read with ``ast`` (no import
    of the module, so no JAX)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no __all__ in {path}")


def test_service_exports_match_reference():
    """The port's ``fhe_client.service.__all__`` is the reference's, name
    for name, and every name resolves."""
    import repro_torch.fhe_client.service as port
    ref = _reference_all(SRC / "repro" / "fhe_client" / "service"
                         / "__init__.py")
    assert sorted(port.__all__) == sorted(ref)
    assert port.__all__ == _reference_all(
        PORT / "fhe_client" / "service" / "__init__.py")
    for name in port.__all__:
        assert getattr(port, name) is not None


def test_import_with_jax_poisoned():
    names = [_module_name(p) for p in MODULES]
    code = (
        "import sys\n"
        "for bad in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[bad] = None\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok', len(" + repr(names) + "))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_nvcc_flags_are_ieee_exact():
    flags = build.NVCC_FLAGS
    assert "--fmad=false" in flags
    assert "-prec-div=true" in flags and "-ftz=false" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    assert "arch=compute_90a,code=sm_90a" in flags


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        FHEClient("tiny")


def test_lm_entry_points_raise_without_cuda():
    """The LM substrate's entry points run on the card unless the caller
    passes device='cpu': without CUDA each raises, the two CLIs too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.fhe_client import private_inference
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.archs import get_arch, reduced_config
    from repro_torch.serving.engine import ServingEngine
    cfg = reduced_config(get_arch("h2o-danube-3-4b"))
    gen = torch.Generator()
    params = M.init_params(cfg, gen, device="cpu")
    calls = {
        "init_params": lambda: M.init_params(cfg, gen),
        "params_from_numpy": lambda: M.params_from_numpy(
            {"w": np.zeros(2, np.float32)}),
        "ServingEngine": lambda: ServingEngine(cfg, params),
        "serve": lambda: serve.serve(cfg, 1, 4, 2),
        "private_inference.run": lambda: private_inference.run(
            reduced_config(get_arch("qwen2-vl-2b")), "tiny"),
        "serve CLI": lambda: serve.main(["--smoke"]),
        "private_inference CLI": lambda: private_inference.main([]),
    }
    for what, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="generator"):
        M.init_params(cfg, gen, device="meta")


def test_training_entry_points_raise_without_cuda():
    """The training path runs on the card unless told otherwise:
    ``init_train_state``, ``checkpoint.restore`` and both training CLIs
    raise without CUDA when given no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.distributed import checkpoint
    from repro_torch.launch import train, train_lm
    from repro_torch.models.archs import get_arch, reduced_config
    from repro_torch.training import train_step
    cfg = reduced_config(get_arch("mamba2-130m"))
    tree = {"w": torch.zeros(3)}
    calls = {
        "init_train_state": lambda: train_step.init_train_state(
            cfg, torch.Generator()),
        "restore": lambda: checkpoint.restore(tree, "no-such-directory"),
        "train CLI": lambda: train.main(["--smoke", "--steps", "1"]),
        "train_lm CLI": lambda: train_lm.main(["--steps", "1"]),
    }
    for what, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


_CORES = {
    "host": ("host", "staged", "f64", "_encrypt_core_impl", None, 1),
    "mega64": ("device", "megakernel", "f64", "_encrypt_core_mega_impl",
               "_decrypt_core_mega_impl", 2),
}


@pytest.mark.parametrize("kwargs", [
    {"fourier": "host"}, {"pipeline": "megakernel", "datapath": "f64"},
    {"datapath": "f64"}])
def test_unported_configurations_raise(kwargs):
    """The three configurations the port once refused now construct, with
    the reference's defaults, and select their cores: the host oracle
    (staged, f64) and the f64 megakernel (the device default pipeline)."""
    client = FHEClient("tiny", device="cpu", **kwargs)
    want = _CORES["host" if "fourier" in kwargs else "mega64"]
    fourier, pipeline, datapath, enc, dec, n_ops = want
    assert (client.fourier, client.pipeline, client.datapath) == (
        fourier, pipeline, datapath)
    assert client.encrypt_impl == getattr(client, enc)
    assert client.n_encrypt_operands == n_ops
    assert len(client.encrypt_operands(np.zeros((2, 32), complex))) == n_ops
    if dec is not None:
        assert client.decrypt_impl == getattr(client, dec)


def _reference_params(cls: str, method: str) -> list[str]:
    """The parameter names of the JAX package's ``cls.method``, read from
    its source with ``ast`` (the rules file imports no JAX)."""
    path = SRC / "repro" / "fhe_client" / "client.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) and fn.name == method:
                    return [a.arg for a in fn.args.posonlyargs + fn.args.args]
    raise AssertionError(f"{cls}.{method} not found in {path}")


@pytest.mark.parametrize("method", ["__init__", "make_evaluation_keys"])
def test_client_positional_parameters_match_reference(method):
    """The port's positional parameters are the reference's, in its order;
    the port's ``device`` is keyword-only, after them."""
    import inspect
    params = inspect.signature(getattr(FHEClient, method)).parameters
    positional = [n for n, p in params.items()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    assert positional == _reference_params("FHEClient", method)
    if method == "__init__":
        assert params["device"].kind == inspect.Parameter.KEYWORD_ONLY


def test_client_binds_positional_arguments_as_reference():
    """``FHEClient('tiny', 0, 'host')`` names the host oracle, as in the
    reference: the third positional argument is ``fourier``."""
    client = FHEClient("tiny", 0, "host", device="cpu")
    assert (client.fourier, client.pipeline, client.datapath) == (
        "host", "staged", "f64")
    assert client.seed == 0
    assert client.device == torch.device("cpu")
    client = FHEClient("tiny", 5, "device", "staged", "f64", device="cpu")
    assert (client.seed, client.fourier, client.pipeline,
            client.datapath) == (5, "device", "staged", "f64")
    with pytest.raises(TypeError):
        FHEClient("tiny", 0, "host", "staged", "f64", "cpu")


@pytest.mark.parametrize("kwargs,match", [
    ({"fourier": "host", "pipeline": "megakernel"}, "megakernel"),
    ({"fourier": "host", "datapath": "df32"}, "df32"),
    ({"fourier": "gpu"}, "fourier"),
    ({"datapath": "f16"}, "datapath"),
    ({"pipeline": "fused", "fourier": "host"}, "pipeline")])
def test_reference_configuration_rules(kwargs, match):
    """The reference's rules: the megakernel and the df32 datapath need the
    device Fourier engine; unknown names raise."""
    with pytest.raises(ValueError, match=match):
        FHEClient("tiny", device="cpu", **kwargs)


def test_staged_pipeline_accepted_and_defaults_to_card():
    client = FHEClient("tiny", device="cpu", pipeline="staged")
    assert client.pipeline == "staged"
    assert client.encrypt_impl == client._encrypt_core_dev32_impl
    with pytest.raises(ValueError, match="pipeline"):
        FHEClient("tiny", device="cpu", pipeline="fused")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        FHEClient("tiny", pipeline="staged")


def test_fourier_host_mode_raises(tiny_client, monkeypatch):
    """The host mode is the complex128 numpy oracle (core.fft, called
    through the module attribute); an unknown mode still raises."""
    from repro_torch.core import fft as fftmod
    ctx = tiny_client.ctx
    z = np.random.default_rng(2).standard_normal((3, 32)) + 1j
    cfg = common.FourierConfig(mode="host")
    np.testing.assert_array_equal(ops.fourier(z, ctx, cfg),
                                  fftmod.special_fft(z, ctx.params.m))
    np.testing.assert_array_equal(ops.fourier(z, ctx, cfg, inverse=True),
                                  fftmod.special_ifft(z, ctx.params.m))
    calls = []
    monkeypatch.setattr(fftmod, "special_fft",
                        lambda v, m: calls.append(m) or v)
    ops.fourier(z, ctx, cfg)
    assert calls == [ctx.params.m]
    x = torch.zeros((3, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="Fourier mode"):
        ops.fourier(x, ctx, common.FourierConfig(mode="dft"))


@pytest.fixture(scope="module")
def tiny_client():
    return FHEClient("tiny", device="cpu")


@pytest.mark.parametrize("scale", [3.0 * 2 ** 38, 2.0 ** 40 + 1, -2.0 ** 40])
def test_non_power_of_two_scale_rejected(tiny_client, scale):
    cts = tiny_client.encode_encrypt_batch(np.zeros((1, 32), complex))
    cts.scale = scale
    with pytest.raises(ValueError, match="power-of-two"):
        tiny_client.decrypt_decode_batch(cts)


def test_keys_from_numpy_round_trip(tiny_client):
    sk, pk = tiny_client.keys.sk, tiny_client.keys.pk
    arrays = [t.numpy().view(np.uint32) for t in (sk.s_mont, pk.b_mont,
                                                  pk.a_mont)]
    keys = keys_from_numpy(*arrays, sk.s_coeffs.numpy(), "cpu")
    for got, want in ((keys.sk.s_mont, sk.s_mont), (keys.pk.b_mont, pk.b_mont),
                      (keys.pk.a_mont, pk.a_mont),
                      (keys.sk.s_coeffs, sk.s_coeffs)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    other = FHEClient("tiny", seed=99, device="cpu")
    other.load_keys(*arrays, sk.s_coeffs.numpy())
    msgs = np.full((2, 32), 0.25 + 0.5j)
    out = other.decrypt_decode_batch(
        tiny_client.encode_encrypt_batch(msgs).truncated(2))
    assert np.max(np.abs(out - msgs)) < 2.0 ** -19


def test_plain_path_counts_no_launch(tiny_client):
    client_stream.reset_launches()
    msgs = np.full((3, 32), -0.125j)
    tiny_client.decrypt_decode_batch(
        tiny_client.encode_encrypt_batch(msgs).truncated(2))
    assert client_stream.LAUNCHES == {"encode_encrypt_stream": 0,
                                      "decrypt_decode_stream": 0,
                                      "encode_encrypt_stream_f64": 0,
                                      "decrypt_decode_stream_f64": 0}


def test_staged_plain_path_counts_no_launch():
    client = FHEClient("tiny", device="cpu", pipeline="staged")
    ops.reset_launches()
    msgs = np.full((2, 32), 0.375 - 0.25j)
    out = client.decrypt_decode_batch(
        client.encode_encrypt_batch(msgs).truncated(2))
    assert np.max(np.abs(out - msgs)) < 2.0 ** -19
    counts = ops.launches()
    assert set(counts) == {"encode_encrypt_stream", "decrypt_decode_stream",
                           "ntt_limbs", "intt_limbs", "encrypt_limbs",
                           "decrypt_limbs", "special_fft", "special_ifft",
                           "add_ct", "add_pt", "mul_pt", "rescale",
                           "mul_pt_rescale", "mul_ct", "rotate",
                           "ks_decompose", "ks_apply_rot", "ntt_rows",
                           "intt_rows", "encrypt_limb", "decrypt_limb",
                           "ntt_rows_mm", "intt_rows_mm",
                           "encode_encrypt_stream_f64",
                           "decrypt_decode_stream_f64"}
    assert not any(counts.values()), counts


@pytest.mark.parametrize("kwargs", [{"datapath": "f64"},
                                    {"fourier": "host"}])
def test_f64_plain_paths_count_no_launch(kwargs):
    """The f64 megakernel and the host oracle client on the CPU run the
    plain versions: every launch counter stays 0."""
    client = FHEClient("tiny", device="cpu", **kwargs)
    ops.reset_launches()
    msgs = np.full((2, 32), -0.25 + 0.125j)
    out = client.decrypt_decode_batch(
        client.encode_encrypt_batch(msgs).truncated(2))
    assert np.max(np.abs(out - msgs)) < 2.0 ** -19
    counts = ops.launches()
    assert not any(counts.values()), counts


def test_per_prime_plain_paths_count_no_launch(tiny_client):
    """K12, K13 and K14's entry points on CPU tensors run the plain
    versions: every launch counter stays 0."""
    ctx = tiny_client.ctx
    keys = tiny_client.keys
    x = torch.zeros((3, 2, 64), dtype=torch.int32)
    ops.reset_launches()
    for path in ops.NTT_PATHS:
        y = ops.ntt_limbs(x, ctx, path=path)
        assert torch.equal(ops.intt_limbs(y, ctx, path=path), x)
    y = ntt_butterfly.intt_rows(ntt_butterfly.ntt_rows(x[0], ctx.plans[0]),
                                ctx.plans[0])
    y = ntt_matmul.intt_rows_mm(ntt_matmul.ntt_rows_mm(y, ctx.plans[0]),
                                ctx.plans[0])
    c0, c1 = client_pointwise.encrypt_limb(x[0], keys.pk.b_mont[0],
                                           keys.pk.a_mont[0], ctx, 0,
                                           tiny_client.seed, 3)
    client_pointwise.decrypt_limb(c0, c1, keys.sk.s_mont[0], ctx, 0)
    counts = ops.launches()
    assert not any(counts.values()), counts


def test_ntt_limbs_refuses_unknown_path(tiny_client):
    x = torch.zeros((3, 1, 64), dtype=torch.int32)
    for f in (ops.ntt_limbs, ops.intt_limbs):
        with pytest.raises(ValueError, match="NTT path"):
            f(x, tiny_client.ctx, path="bogus")


@pytest.mark.parametrize("wrapper", [
    "ntt_limbs", "encrypt_limbs", "decrypt_limbs", "fft_rows", "ntt_rows",
    "encrypt_limb", "decrypt_limb", "ntt_rows_mm"])
def test_staged_cuda_wrappers_refuse_cpu_tensors(tiny_client, wrapper):
    ctx = tiny_client.ctx
    x = torch.zeros((1, 3, 64), dtype=torch.int32)
    s, b = tiny_client.keys.sk.s_mont, tiny_client.keys.pk.b_mont
    calls = {
        "ntt_limbs": lambda: ntt_butterfly.limb_rows_cuda(
            x.reshape(3, 1, 64), ctx.plans[:3], False),
        "encrypt_limbs": lambda: client_pointwise.encrypt_limbs_cuda(
            x, b, b, ctx, 1, 0),
        "decrypt_limbs": lambda: client_pointwise.decrypt_limbs_cuda(
            x[:, :2], x[:, :2], s, ctx),
        "fft_rows": lambda: fft_df.special_fft_cuda(
            tuple(torch.zeros((1, 32)) for _ in range(4)), ctx.params.m,
            True),
        "ntt_rows": lambda: ntt_butterfly.rows_cuda(x[0], ctx.plans[0],
                                                    False),
        "encrypt_limb": lambda: client_pointwise.encrypt_limb_cuda(
            x[:, 0], b[0], b[0], ctx, 0, 1, 0),
        "decrypt_limb": lambda: client_pointwise.decrypt_limb_cuda(
            x[:, 0], x[:, 0], s[0], ctx, 0),
        "ntt_rows_mm": lambda: ntt_matmul.limb_rows_mm_cuda(
            x.reshape(3, 1, 64), ctx.plans[:3], True),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[wrapper]()


def test_cuda_wrappers_refuse_cpu_tensors(tiny_client):
    planes = tiny_client.encrypt_operands(np.zeros((1, 32), complex))
    with pytest.raises(ValueError, match="CUDA"):
        client_stream.encode_encrypt_stream_cuda(
            planes, tiny_client.keys.pk.b_mont, tiny_client.keys.pk.a_mont,
            tiny_client.ctx, tiny_client.seed, 0)


@pytest.mark.parametrize("datapath", ["df32", "f64"])
def test_megakernel_wrappers_refuse_cpu_tensors_on_each_datapath(
        tiny_client, datapath):
    """K5 and K6's CUDA wrappers refuse CPU tensors on either datapath,
    and an unknown datapath."""
    keys, ctx = tiny_client.keys, tiny_client.ctx
    planes = tiny_client.encrypt_operands(np.zeros((1, 32), complex))
    c = torch.zeros((1, 3, 64), dtype=torch.int32)
    scale = torch.ones(1, dtype=torch.float32 if datapath == "df32"
                       else torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        client_stream.encode_encrypt_stream_cuda(
            planes, keys.pk.b_mont, keys.pk.a_mont, ctx, tiny_client.seed, 0,
            datapath)
    with pytest.raises(ValueError, match="CUDA"):
        client_stream.decrypt_decode_stream_cuda(
            c[:, :2], c[:, :2], keys.sk.s_mont, ctx, scale, datapath)
    with pytest.raises(ValueError, match="datapath"):
        client_stream.encode_encrypt_stream_plain(
            planes, keys.pk.b_mont, keys.pk.a_mont, ctx, tiny_client.seed, 0,
            "f16")


def test_simulate_private_inference(tiny_client):
    """Rows wider than one ciphertext (F=100 > 64 slots) split over two
    ciphertexts and come back within the df32 datapath's precision."""
    x = np.random.default_rng(0).uniform(-1, 1, (3, 100))
    y, info = simulate_private_inference(
        tiny_client, lambda a: 2.0 * a[:, :7], x, out_features=7)
    assert y.shape == (3, 7)
    assert info["roundtrip_err"] < 2.0 ** -19
    np.testing.assert_allclose(y, 2.0 * x[:, :7], atol=2.0 ** -17)
    assert tiny_client.ciphertext_bytes() == 2 * 3 * 64 * 4


# The reference's signatures against the port's, read with ``ast`` (no JAX).
# Allowed deviations: the reference's Pallas-only parameters are dropped,
# and the port may append ``device``.
PALLAS_ONLY = ("interpret", "block_rows", "batch_block")
SIGNATURES = [("kernels/ops.py", "kernels.ops", name) for name in (
    "server_add_ct", "server_add_pt", "server_mul_pt", "server_rescale",
    "server_mul_ct", "server_rotate", "server_ks_decompose",
    "server_ks_apply_rot", "encode_encrypt_stream",
    "decrypt_decode_stream")] + [("core/prng.py", "core.prng", "cbd")] + [
    (f"kernels/{mod}.py", f"kernels.{mod}", name) for mod, names in (
        ("client_stream", ("encode_encrypt_stream", "decrypt_decode_stream")),
        ("client_pointwise", ("encrypt_limbs", "decrypt_limbs")),
        ("ntt_butterfly", ("ntt_limb_rows", "intt_limb_rows")),
        ("server_eval", ("add_ct", "add_pt", "mul_pt", "rescale",
                         "mul_pt_rescale", "mul_ct_relin", "rotate",
                         "ks_decompose", "ks_apply_rot")))
    for name in names]


def _reference_signature(rel: str, name: str) -> list:
    """[(name, default or ``inspect.Parameter.empty``)] of the reference's
    module-level function ``name``, without its Pallas-only parameters."""
    import inspect
    path = SRC / "repro" / rel
    tree = ast.parse(path.read_text(), filename=str(path))
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name == name:
            args = fn.args.posonlyargs + fn.args.args
            defaults = [inspect.Parameter.empty] * (
                len(args) - len(fn.args.defaults)) + [
                ast.literal_eval(d) for d in fn.args.defaults]
            return [(a.arg, d) for a, d in zip(args, defaults)
                    if a.arg not in PALLAS_ONLY]
    raise AssertionError(f"{name} not found in {path}")


@pytest.mark.parametrize(
    "rel,module,name", SIGNATURES,
    ids=[s[2] if s[1] in ("kernels.ops", "core.prng")
         else f"{s[1].split('.')[-1]}.{s[2]}" for s in SIGNATURES])
def test_signatures_match_reference(rel, module, name):
    """Each listed function takes the reference's positional parameters in
    its order, with its defaults: a call written for the reference binds
    the same way in the port."""
    import importlib
    import inspect
    fn = getattr(importlib.import_module(f"repro_torch.{module}"), name)
    params = inspect.signature(fn).parameters
    got = [(n, p.default) for n, p in params.items()
           if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    want = _reference_signature(rel, name)
    if len(got) == len(want) + 1 and got[-1][0] == "device":
        got = got[:-1]
    assert got == want
    assert not [n for n, p in params.items() if p.kind == p.KEYWORD_ONLY
                and n != "device"]


def test_cbd_takes_eta_as_reference():
    """``cbd(seed, stream, n, 21)`` binds ``eta``, and eta above 21 fails
    the reference's assert."""
    from repro_torch.core import prng
    a = prng.cbd(7, 3, 64, 21)
    assert torch.equal(a, prng.cbd(7, 3, 64, device="cpu"))
    with pytest.raises(AssertionError):
        prng.cbd(7, 3, 64, 22)


def test_server_mul_pt_binds_datapath_positionally(tiny_client):
    """``server_mul_pt(c0, c1, pt, ctx, 'f64')`` names the datapath, as in
    the reference, and keeps every limb (no fused rescale)."""
    ctx = tiny_client.ctx
    x = torch.zeros((1, 3, 64), dtype=torch.int32)
    pt = torch.zeros((3, 64), dtype=torch.int32)
    c0, c1 = ops.server_mul_pt(x, x, pt, ctx, "f64")
    assert tuple(c0.shape) == tuple(c1.shape) == (1, 3, 64)
    c0, _ = ops.server_mul_pt(x, x, pt, ctx, "f64", True)
    assert tuple(c0.shape) == (1, 2, 64)


def test_stream_entries_take_reference_defaults(tiny_client):
    """The ops-level stream entries called as the reference's tests call
    them (``nonce0=0``, no seed: the profile's): the f64 datapath by
    default, the client's words."""
    ctx = tiny_client.ctx
    keys = tiny_client.keys
    msgs = np.full((2, 32), 0.25 - 0.5j)
    planes = tiny_client.encrypt_operands(msgs)
    c0, c1 = ops.encode_encrypt_stream(planes, keys.pk.b_mont,
                                       keys.pk.a_mont, ctx, nonce0=0)
    w0, w1 = ops.encode_encrypt_stream(planes, keys.pk.b_mont,
                                       keys.pk.a_mont, ctx, ctx.params.seed,
                                       0, "f64")
    assert torch.equal(c0, w0) and torch.equal(c1, w1)
    scale = torch.full((2,), ctx.params.delta, dtype=torch.float64)
    out = ops.decrypt_decode_stream(c0[:, :2], c1[:, :2], keys.sk.s_mont,
                                    ctx, scale)
    want = ops.decrypt_decode_stream(c0[:, :2], c1[:, :2], keys.sk.s_mont,
                                     ctx, scale, "f64")
    assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.parametrize("package", ["core", "fhe_server"])
def test_package_exports_match_reference(package):
    """``repro_torch.core`` and ``repro_torch.fhe_server`` export the
    reference's names (``from repro_torch.core import keygen`` works), and
    every name resolves."""
    import importlib
    port = importlib.import_module(f"repro_torch.{package}")
    ref = _reference_all(SRC / "repro" / package / "__init__.py")
    assert sorted(getattr(port, "__all__", [])) == sorted(ref)
    for name in ref:
        assert getattr(port, name) is not None


# The names rule: every public name the reference's modules define (top-level
# functions, classes, class methods, module constants; no leading ``_``) has
# a same-named counterpart in the port's module of the same path, defined or
# imported there. The deviations, each by design:
NAME_DEVIATIONS = {
    ("kernels/common.py", "row_block_spec"):
        "a Pallas BlockSpec; the CUDA launches take pointers and strides",
    ("kernels/common.py", "row_grid"):
        "a Pallas grid; each CUDA wrapper sizes its own launch",
    ("kernels/common.py", "table_block_spec"):
        "a Pallas BlockSpec of a VMEM-resident table",
    ("kernels/common.py", "balanced_digits_jnp"):
        "the jnp twin of balanced_digits_np; the port's is balanced_digits",
    ("kernels/ops.py", "default_interpret"):
        "Pallas interpret-mode plumbing; the port routes by device",
    ("core/modmul.py", "U32"): "a jnp dtype alias",
    ("core/modmul.py", "U64"): "a jnp dtype alias",
    ("core/prng.py", "U32"): "a jnp dtype alias",
    ("telemetry/probe.py", "CLIENT_CORE_ATTRS"):
        "names jit caches; the port has DEVICE_CLIENTS_ATTR",
    ("telemetry/probe.py", "jit_cache_entries"):
        "counts jit caches; the port has table_cache_entries",
    ("launch/dryrun.py", "collective_bytes"):
        "parses compiled HLO text; the port's dryrun.collectives models the "
        "placements and returns the same keys",
}
REF_MODULES = sorted(p.relative_to(SRC / "repro").as_posix()
                     for p in (SRC / "repro").rglob("*.py"))


def _public_names(path: Path, imports: bool) -> set:
    """The public names ``path`` defines at top level, with its classes'
    methods as ``Class.method``; with ``imports``, also the names its
    top-level imports bind."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out |= {f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in out if not any(p.startswith("_")
                                      for p in n.split("."))}


def test_public_name_deviations_are_exact():
    """Each named deviation is a reference name with no counterpart."""
    for rel, name in NAME_DEVIATIONS:
        assert name in _public_names(SRC / "repro" / rel, imports=False)
        assert name not in _public_names(PORT / rel, imports=True)


@pytest.mark.parametrize("rel", REF_MODULES)
def test_public_names_match_reference(rel):
    """Every public name of the reference module has a counterpart in the
    port's module of the same path, but for the named deviations."""
    port = PORT / rel
    assert port.is_file(), f"no port module {rel}"
    missing = (_public_names(SRC / "repro" / rel, imports=False)
               - _public_names(port, imports=True)
               - {n for r, n in NAME_DEVIATIONS if r == rel})
    assert not missing, f"{rel}: no counterpart for {sorted(missing)}"


def test_mesh_worker_serve_takes_no_argument():
    """``MeshWorker.serve()`` takes what the reference's takes (nothing):
    it starts its own frame reader."""
    import inspect
    from repro_torch.fhe_client.service.worker import MeshWorker
    path = SRC / "repro" / "fhe_client" / "service" / "worker.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
               and n.name == "MeshWorker")
    fn = next(f for f in cls.body if isinstance(f, ast.FunctionDef)
              and f.name == "serve")
    assert [a.arg for a in fn.args.args] == ["self"]
    assert list(inspect.signature(MeshWorker.serve).parameters) == ["self"]


# The reference's ``assert`` guards against the port's, read with ``ast``:
# where a function of the reference guards with ``assert``, the function of
# the same qualified name at the same relative path of the port holds at
# least as many ``assert`` statements, so a caller that expects the
# reference's ``AssertionError`` sees it (and ``python -O`` drops the same
# checks in both). The port's own device and generator checks stay
# ``ValueError``: the reference has no assert there. Allowed deviations,
# "rel::qualname" -> one-line reason:
ASSERT_DEVIATIONS: dict = {}


def _asserts_by_function(path: Path) -> dict:
    """{qualified name: number of ``assert`` statements in its body}."""
    counts = {}

    def walk(node, prefix):
        for ch in ast.iter_child_nodes(node):
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = prefix + ch.name
                counts[name] = sum(isinstance(n, ast.Assert)
                                   for n in ast.walk(ch))
                walk(ch, name + ".")
            elif isinstance(ch, ast.ClassDef):
                walk(ch, prefix + ch.name + ".")

    walk(ast.parse(path.read_text(), filename=str(path)), "")
    return counts


REF_ASSERT_SITES = sorted(
    (str(p.relative_to(SRC / "repro")), name, n)
    for p in (SRC / "repro").rglob("*.py")
    for name, n in _asserts_by_function(p).items() if n)


def test_reference_assert_sites_found():
    """The scan sees the reference's guarded functions (29 at this port)."""
    assert len(REF_ASSERT_SITES) >= 29
    assert ("fhe_server/eval_ops.py", "ServerEvaluator.rescale", 1) \
        in REF_ASSERT_SITES


@pytest.mark.parametrize("rel,name,n", REF_ASSERT_SITES,
                         ids=[f"{r}::{q}" for r, q, _ in REF_ASSERT_SITES])
def test_asserts_match_reference(rel, name, n):
    if f"{rel}::{name}" in ASSERT_DEVIATIONS:
        return
    port = PORT / rel
    assert port.exists(), f"no port of {rel}"
    got = _asserts_by_function(port)
    assert name in got, f"{rel} of the port has no {name}"
    assert got[name] >= n, (
        f"{rel}::{name}: the reference asserts {n} time(s), the port "
        f"{got[name]}")


def _guard_env(which: str):
    """The names a guard case needs, from the reference (JAX, in-process)
    or from the port (CPU tensors)."""
    from types import SimpleNamespace
    if which == "ref":
        import jax.numpy as jnp
        from repro.core import encoder, get_context
        from repro.fhe_server import (ServerCiphertext, ServerEvaluator,
                                      ServerPlaintext)
        from repro.models import layers, tuning
        return SimpleNamespace(
            encoder=encoder, ctx=get_context("tiny"), CT=ServerCiphertext,
            PT=ServerPlaintext, Ev=ServerEvaluator, layers=layers,
            tuning=tuning, words=lambda s: jnp.zeros(s, jnp.uint32),
            floats=lambda s, dt="f64": jnp.zeros(
                s, jnp.float64 if dt == "f64" else jnp.float32),
            ints=lambda s: jnp.zeros(s, jnp.int32))
    from repro_torch.core import encoder, get_context
    from repro_torch.fhe_server import (ServerCiphertext, ServerEvaluator,
                                        ServerPlaintext)
    from repro_torch.models import layers, tuning
    return SimpleNamespace(
        encoder=encoder, ctx=get_context("tiny"), CT=ServerCiphertext,
        PT=ServerPlaintext, Ev=ServerEvaluator, layers=layers,
        tuning=tuning, words=lambda s: torch.zeros(s, dtype=torch.int32),
        floats=lambda s, dt="f64": torch.zeros(
            s, dtype=torch.float64 if dt == "f64" else torch.float32),
        ints=lambda s: torch.zeros(s, dtype=torch.int32))


def _ct(e, level, scale=None):
    n = e.ctx.params.n
    return e.CT(e.words((1, level, n)), e.words((1, level, n)), level,
                e.ctx.params.delta if scale is None else scale)


GUARD_CASES = {
    "rescale_at_level_2": lambda e: e.Ev(e.ctx).rescale(_ct(e, 2)),
    "drop_to_1": lambda e: _ct(e, 3).drop_to(1),
    "add_ct_scale_mismatch": lambda e: e.Ev(e.ctx).add_ct(
        _ct(e, 3), _ct(e, 3, 2 * e.ctx.params.delta)),
    "add_pt_scale_mismatch": lambda e: e.Ev(e.ctx).add_pt(
        _ct(e, 3), e.PT(e.words((3, e.ctx.params.n)),
                        e.words((3, e.ctx.params.n)), 3,
                        2 * e.ctx.params.delta)),
    "mul_ct_without_relin_key": lambda e: e.Ev(e.ctx).mul_ct(
        _ct(e, 3), _ct(e, 3)),
    "apply_mrope_bad_sections": lambda e: e.layers.apply_mrope(
        e.floats((1, 2, 1, 32), "f32"), e.ints((1, 2, 3)), 1e4, (4, 4, 4)),
    "set_perf_unknown_knob": lambda e: e.tuning.set_perf(no_such_knob=1),
    "slots_to_coeffs_device_shapes": lambda e: (
        e.encoder.slots_to_coeffs_device(
            e.floats((2, e.ctx.params.n_slots)),
            e.floats((3, e.ctx.params.n_slots)), e.ctx)),
    "coeffs_to_slots_device_width": lambda e: (
        e.encoder.coeffs_to_slots_device(
            e.floats((1, e.ctx.params.n + 2)),
            e.floats((1, e.ctx.params.n + 2)), e.ctx, 1.0)),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guards_raise_as_reference(case):
    """The reference and the port, on the same bad input, raise the same
    exception type (the reference's ``assert``: ``AssertionError``)."""
    with pytest.raises(Exception) as want:
        GUARD_CASES[case](_guard_env("ref"))
    with pytest.raises(Exception) as got:
        GUARD_CASES[case](_guard_env("port"))
    assert got.type is want.type, f"{case}: {want.type} vs {got.type}"
