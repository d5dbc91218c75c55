"""The model half of ``repro_torch.distributed.sharding``, ``launch.mesh``
and ``launch.specs`` against the JAX package, in one process.

Sharding rules: the mirrors of ``tests/test_sharding.py``'s four tests
(divisibility for the 10 archs, the matrix rules, MoE expert parallelism,
cache specs) on the same 4x4 ('data', 'model') mesh; beyond them every
leaf's spec of the params (10 reduced archs), the 8-bit optimizer state,
every shape's batch and every decode cache equals the reference's
``PartitionSpec`` on that mesh (the JAX side needs only
``jax.eval_shape`` and a ``Mesh`` of the one CPU device repeated, as that
file uses). Specs: every leaf's shape and dtype of ``launch.specs.
input_specs`` equals the reference's ``jax.eval_shape`` stand-in for all
10 archs at full size, for every runnable shape. Placements: a spec's
DTensor placements shard a tensor as ``NamedSpec.shard_shape`` says, on a
real ``DeviceMesh`` of four CPU processes (gloo). Tolerance: none (specs,
shapes and dtypes are exact).
"""

import functools
import os
import socket

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs import shapes as jshapes
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import archs as jarchs
from repro.models import model as JM
from repro.training import optimizer as jopt
from repro_torch.configs.shapes import SHAPES, runnable
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as S
from repro_torch.models import model as M
from repro_torch.models.archs import ARCHS, get_arch, reduced_config
from repro_torch.training import optimizer as opt

NAMES = sorted(ARCHS)
CELLS = [(a, s) for a in NAMES for s in SHAPES if runnable(get_arch(a), s)]


@pytest.fixture(scope="module")
def mesh():
    # 16 logical devices is enough to validate divisibility rules (4x4)
    return tmesh.make_mesh((4, 4), ("data", "model"))


@pytest.fixture(scope="module")
def jmesh():
    devs = np.asarray(jax.devices("cpu") * 16)[:16].reshape(4, 4)
    return Mesh(devs, ("data", "model"))


def _reduced(name):
    return reduced_config(get_arch(name), d_model=256, vocab=512)


def _jreduced(name):
    return jarchs.reduced_config(jarchs.get_arch(name), d_model=256,
                                 vocab=512)


@functools.lru_cache(maxsize=None)
def _jparams(name, tp, reduced=True):
    cfg = _jreduced(name) if reduced else jarchs.get_arch(name)
    return jax.eval_shape(
        lambda: JM.init_params(cfg, jax.random.PRNGKey(0), tp=tp))


def _flat(tree, path=()):
    """{path: leaf} of a nested dict (a ``Cache`` by its fields)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (str(k),)))
        return out
    if isinstance(tree, (M.Cache, JM.Cache)):
        return {path + (f,): getattr(tree, f) for f in M.FIELDS
                if getattr(tree, f) is not None}
    return {path: tree}


def _same_specs(port, ref):
    """Every leaf's port spec == the reference's PartitionSpec."""
    a, b = _flat(port), _flat(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].spec == tuple(b[k].spec), k


def _check_divisible(leaf, spec, mesh):
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        names = (axis,) if isinstance(axis, str) else axis
        n = int(np.prod([mesh.shape[a] for a in names]))
        assert leaf.shape[dim] % n == 0, (leaf.shape, spec)


# ---------------------------------------------------------------------------
# the mirrors of tests/test_sharding.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_divide(name, mesh, jmesh):
    """Every param leaf's spec divides on the 4x4 mesh and equals the
    reference's."""
    cfg = _reduced(name)
    tp = mesh.shape["model"]
    params = S.param_specs(cfg, tp)
    shardings = sh.param_shardings(params, mesh)
    flat_p, flat_s = _flat(params), _flat(shardings)
    assert sorted(flat_p) == sorted(flat_s)
    for k, leaf in flat_p.items():
        _check_divisible(leaf, flat_s[k].spec, mesh)
    _same_specs(shardings, jsh.param_shardings(_jparams(name, tp), jmesh))


def test_matrix_rules(mesh):
    """Column-parallel wq -> model on out dim; row-parallel wo -> model on
    in dim; embeddings vocab -> model."""
    cfg = _reduced("yi-34b")
    params = S.param_specs(cfg, mesh.shape["model"])
    sp = sh.param_shardings(params, mesh)
    assert sp["layers"]["attn"]["wq"].spec == (None, "data", "model")
    assert sp["layers"]["attn"]["wo"].spec == (None, "model", "data")
    assert sp["layers"]["mlp"]["wo"].spec == (None, "model", "data")
    assert sp["embed"]["tok"].spec == ("model", "data")


def test_moe_expert_parallel(mesh):
    cfg = _reduced("phi3.5-moe-42b-a6.6b")
    params = S.param_specs(cfg, mesh.shape["model"])
    sp = sh.param_shardings(params, mesh)
    spec = sp["layers"]["moe"]["wi"].spec
    assert spec[1] == "data"           # experts -> EP over data
    assert spec[3] == "model"          # expert d_ff -> TP


def test_cache_specs(mesh, jmesh):
    cfg = get_arch("yi-34b")
    cache = M.cache_spec(cfg, batch=128, cache_len=32768,
                         tp=mesh.shape["model"])
    cs = sh.cache_shardings(cache, mesh, cfg)
    assert cs.k.spec[1] == "data"      # batch
    assert cs.k.spec[2] == "model"     # sequence
    # long-context: sequence over the whole mesh
    cfg_h = get_arch("hymba-1.5b")
    cache_l = M.cache_spec(cfg_h, batch=1, cache_len=524288,
                           tp=mesh.shape["model"])
    cl = sh.cache_shardings(cache_l, mesh, cfg_h, long_context=True)
    assert cl.k.spec[2] == ("data", "model")
    for c, jc, arch, long in (
            (cs, (128, 32768), "yi-34b", False),
            (cl, (1, 524288), "hymba-1.5b", True)):
        jcfg = jarchs.get_arch(arch)
        jcache = JM.cache_spec(jcfg, jc[0], jc[1], 4)
        _same_specs(c, jsh.cache_shardings(jcache, jmesh, jcfg,
                                           long_context=long))


# ---------------------------------------------------------------------------
# every tree against the reference's PartitionSpecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["yi-34b", "deepseek-v3-671b",
                                  "mamba2-130m", "hymba-1.5b"])
def test_opt_state_shardings_match_reference(name, mesh, jmesh):
    tp = mesh.shape["model"]
    state = S.opt_specs(_reduced(name), tp, opt.AdamWConfig())
    jstate = jax.eval_shape(functools.partial(
        jopt.adamw_init, cfg=jopt.AdamWConfig()), _jparams(name, tp))
    _same_specs(sh.opt_state_shardings(state, mesh),
                jsh.opt_state_shardings(jstate, jmesh))


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_batch_and_cache_shardings_match_reference(shape_name, mesh, jmesh):
    """Every arch's batch and (decode) cache specs at each shape, full
    size, == the reference's; on the two-pod mesh the batch goes over
    ('pod', 'data')."""
    pod = tmesh.make_mesh((2, 2, 4), ("pod", "data", "model"))
    jpod = Mesh(np.asarray(jax.devices("cpu") * 16)[:16].reshape(2, 2, 4),
                ("pod", "data", "model"))
    shape = SHAPES[shape_name]
    for name in NAMES:
        cfg, jcfg = get_arch(name), jarchs.get_arch(name)
        if not runnable(cfg, shape_name):
            continue
        for m, jm in ((mesh, jmesh), (pod, jpod)):
            batch = S.batch_specs(cfg, shape)
            _same_specs(sh.batch_shardings(batch, m), jsh.batch_shardings(
                jspecs.batch_specs(jcfg, jshapes.SHAPES[shape_name]), jm))
            if shape.kind != "decode":
                continue
            tp = tmesh.tp_width(m)
            long = shape_name == "long_500k"
            _same_specs(
                sh.cache_shardings(M.cache_spec(
                    cfg, shape.global_batch, shape.seq_len, tp), m, cfg,
                    long_context=long),
                jsh.cache_shardings(JM.cache_spec(
                    jcfg, shape.global_batch, shape.seq_len, tp), jm, jcfg,
                    long_context=long))
    assert sh.replicated(mesh).spec == tuple(jsh.replicated(jmesh).spec)
    assert sh.batch_axes(pod) == jsh.batch_axes(jpod)


# ---------------------------------------------------------------------------
# launch.specs at full size
# ---------------------------------------------------------------------------


def _dtype_name(d) -> str:
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("arch,shape_name", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_match_eval_shape(arch, shape_name):
    """Every leaf's shape and dtype == the reference's ``input_specs``
    (``jax.eval_shape``) at full size on the production mesh's TP width;
    nothing is allocated (the params are ``TensorSpec``s)."""
    tp = tmesh.tp_width(tmesh.make_production_mesh())
    got = S.input_specs(get_arch(arch), shape_name, tp)
    want = jspecs.input_specs(jarchs.get_arch(arch), shape_name, tp)
    assert sorted(got) == sorted(want)
    for part in got:
        a, b = _flat(got[part]), _flat(want[part])
        assert sorted(a) == sorted(b), part
        for k in a:
            assert isinstance(a[k], M.TensorSpec), (part, k)
            assert tuple(a[k].shape) == tuple(b[k].shape), (part, k)
            assert _dtype_name(a[k].dtype) == str(b[k].dtype), (part, k)


# ---------------------------------------------------------------------------
# meshes, stream meshes, placements
# ---------------------------------------------------------------------------


def test_production_meshes_and_no_device_on_import():
    """The reference's shapes and axis names; importing the module and
    building a mesh starts no process group and touches no card."""
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.sizes) == (("data", "model"), (16, 16))
    assert (multi.axis_names, multi.sizes) == (
        ("pod", "data", "model"), (2, 16, 16))
    assert (single.size, multi.size) == (256, 512)
    assert tmesh.tp_width(single) == tmesh.tp_width(multi) == 16
    assert tmesh.tp_width(tmesh.make_mesh((8,), ("data",))) == 1
    assert not torch.distributed.is_initialized()
    assert not torch.cuda.is_initialized()


def test_stream_mesh_and_batch_stack_sharding():
    """A stream group's ('batch',) mesh: a (B, L, N) stack's device shard
    is the row slice ``kernels.ops.split_rows`` gives each device."""
    from repro_torch.kernels import ops
    cpu = torch.device("cpu")
    m = sh.stream_mesh([cpu, cpu])
    assert (m.axis_names, m.sizes, m.devices) == (("batch",), (2,),
                                                  (cpu, cpu))
    s = sh.batch_stack_sharding(m, 3)
    assert s.spec == ("batch", None, None)
    assert s.shard_shape((16, 3, 64)) == (8, 3, 64)
    rows = ops.split_rows(16, [cpu, cpu],
                          lambda i, dev, sl, r: (sl.stop - sl.start))
    assert rows == [8, 8]


def test_placements_of_specs(mesh):
    from torch.distributed.tensor import Replicate, Shard
    pod = tmesh.make_mesh((2, 2, 4), ("pod", "data", "model"))
    assert sh.NamedSpec(mesh, (None, "data", "model")).placements() == (
        Shard(1), Shard(2))
    assert sh.NamedSpec(mesh, ("model", None)).placements() == (
        Replicate(), Shard(0))
    assert sh.NamedSpec(pod, (("pod", "data"), None)).placements() == (
        Shard(0), Shard(0), Replicate())
    assert sh.replicated(mesh).placements() == (Replicate(), Replicate())
    assert sh.NamedSpec(mesh, (None, ("data", "model"))).shard_shape(
        (3, 64)) == (3, 4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dtensor_worker(rank: int, world: int, port: int) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    dmesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    spec_mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    full = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    d, m = dmesh.get_coordinate()
    for spec in ((None, "data", "model"), ("model", None, "data"),
                 (("data", "model"), None, None), (None, None, None)):
        on_dev, on_spec = sh.NamedSpec(dmesh, spec), sh.NamedSpec(spec_mesh,
                                                                  spec)
        assert on_dev.placements() == on_spec.placements()
        local = distribute_tensor(full, dmesh,
                                  list(on_dev.placements())).to_local()
        assert tuple(local.shape) == on_spec.shard_shape(full.shape), spec
        # the shard is the block of the reference's layout at this device
        idx = []
        for dim, axis in enumerate(spec):
            names = () if axis is None else (
                (axis,) if isinstance(axis, str) else axis)
            k, n = 0, 1
            for name in names:
                size = {"data": 2, "model": 2}[name]
                k = k * size + {"data": d, "model": m}[name]
                n *= size
            step = full.shape[dim] // n
            idx.append(slice(k * step, (k + 1) * step))
        assert torch.equal(local, full[tuple(idx)]), spec
    assert tmesh.tp_width(dmesh) == 2 and sh.batch_axes(dmesh) == "data"
    dist.destroy_process_group()


def test_placements_shard_on_a_device_mesh():
    """Four CPU processes (gloo) on a (2, 2) ('data', 'model')
    ``DeviceMesh``: ``distribute_tensor`` under a spec's placements leaves
    each rank the shard ``shard_shape`` names, at the block the
    reference's layout gives that device."""
    import torch.multiprocessing as mp
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    mp.spawn(_dtensor_worker, args=(4, _free_port()), nprocs=4, join=True)
