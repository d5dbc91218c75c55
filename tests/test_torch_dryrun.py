"""``repro_torch.launch.dryrun`` against the JAX package, in one process.

  * Per-device bytes: for the 10 reduced archs at every runnable shape, a
    cell's argument and output bytes on the 4x4 ('data', 'model') mesh
    equal the sum, over the reference's ``jax.eval_shape`` stand-ins, of
    each leaf's ``NamedSharding.shard_shape`` bytes under the reference's
    shardings (exact).
  * FLOPs: the dry-run's count of the unsharded reduced train cell (and a
    dense prefill), assembled from n_layers = 1 and 2, against the
    reference's ``jax.jit(fn).lower(...).cost_analysis()['flops']`` of the
    same cell in ``benchmarks/roofline.py``'s exact-cost mode (loops
    unrolled, lowered, never compiled), assembled the same way. The port
    counts the products ``FlopCounterMode`` sees; XLA also counts
    elementwise operations, so the port's count is lower. Tolerance:
    port / JAX in [0.90, 1] for the dense and SSM cells (measured 0.9525
    yi-34b train, 0.9487 yi-34b prefill, 0.9446 mamba2-130m train), in
    [0.50, 1] for the MoE cell (measured 0.5753 phi3.5-moe train: XLA's
    count also holds the MoE dispatch's sort, gathers and scatter-adds,
    which the port runs as index operations; not checked op by op).
  * Collectives: the rules of the module docstring on one hand-worked
    cell (a 2-layer dense model, d_model 64, on a 2x2 mesh, train_4k).
  * The CLI: ``python -m repro_torch.launch.dryrun --all --mesh both``
    writes one record per runnable cell and mesh with the reference's
    keys (a subprocess of the port, started first, checked last).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.configs.shapes import SHAPES as JSHAPES
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import archs as jarchs
from repro.models import model as JM
from repro_torch.configs.shapes import SHAPES, runnable
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.archs import ARCHS, get_arch, reduced_config
from repro_torch.models.config import ArchConfig

SRC = str(Path(__file__).resolve().parents[1] / "src")
NAMES = sorted(ARCHS)
# the reference's record keys (src/repro/launch/dryrun.py, run_cell)
RECORD_KEYS = {"arch", "shape", "mesh", "devices", "n_micro", "flops",
               "bytes_accessed", "collectives", "memory", "lower_s",
               "compile_s"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes",
               "alias_size_in_bytes"}
COLLECTIVES = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute"}


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The whole CLI (66 records, ~60 s), started before the other tests
    of the file and read by the last one."""
    out = tmp_path_factory.mktemp("dryrun")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both", "--out", str(out)],
        env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_cli_started(cli_run):
    assert cli_run[0].poll() in (None, 0)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((4, 4), ("data", "model"))


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.asarray(jax.devices("cpu") * 16)[:16].reshape(4, 4),
                ("data", "model"))


def _jax_bytes(tree, shardings) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: hasattr(x, "shard_shape"))
    assert len(leaves) == len(shs)
    return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
               for x, s in zip(leaves, shs))


def _jax_cell_bytes(jcfg, shape_name, jmesh, tp):
    """(argument bytes, output bytes) of the reference's cell on ``jmesh``
    for ``jcfg``: its ``input_specs`` under its ``build_cell``'s
    shardings."""
    shape = JSHAPES[shape_name]
    sp = jspecs.input_specs(jcfg, shape_name, tp)
    params = jsh.param_shardings(sp["params"], jmesh)
    if shape.kind == "train":
        scalars = {k: jax.ShapeDtypeStruct((), np.float32)
                   for k in ("loss", "grad_norm", "lr")}
        opt_sh = jsh.opt_state_shardings(sp["opt_state"], jmesh)
        args = (_jax_bytes(sp["params"], params)
                + _jax_bytes(sp["opt_state"], opt_sh)
                + _jax_bytes(sp["batch"], jsh.batch_shardings(sp["batch"],
                                                              jmesh)))
        outs = (_jax_bytes(sp["params"], params)
                + _jax_bytes(sp["opt_state"], opt_sh)
                + _jax_bytes(scalars, jax.tree.map(
                    lambda _: jsh.replicated(jmesh), scalars)))
        return args, outs
    logits = jax.ShapeDtypeStruct(
        (shape.global_batch, 1, jcfg.padded_vocab(tp)), jax.numpy.bfloat16)
    lg = _jax_bytes(logits, jsh.batch_shardings(logits, jmesh))
    args = (_jax_bytes(sp["params"], params)
            + _jax_bytes(sp["batch"], jsh.batch_shardings(sp["batch"],
                                                          jmesh)))
    if shape.kind == "prefill":
        cache = JM.cache_spec(jcfg, shape.global_batch, shape.seq_len, tp)
        return args, lg + _jax_bytes(
            cache, jsh.cache_shardings(cache, jmesh, jcfg))
    cache_sh = jsh.cache_shardings(sp["cache"], jmesh, jcfg,
                                   long_context=shape_name == "long_500k")
    cache = _jax_bytes(sp["cache"], cache_sh)
    return args + cache + 4, lg + cache


@pytest.mark.parametrize("name", NAMES)
def test_per_device_bytes_match_reference(name, mesh, jmesh):
    """Argument and output bytes of every runnable reduced cell on the
    4x4 mesh == the reference's shard bytes."""
    cfg = reduced_config(get_arch(name))
    jcfg = jarchs.reduced_config(jarchs.get_arch(name))
    for shape_name in SHAPES:
        if not runnable(cfg, shape_name):
            continue
        _, args, in_sh, (out, out_sh) = D.build_cell(name, shape_name, mesh,
                                                     cfg=cfg)
        got = (sum(D.sharded_bytes(a, s) for a, s in zip(args, in_sh)),
               D.sharded_bytes(out, out_sh))
        assert got == _jax_cell_bytes(jcfg, shape_name, jmesh, 4), \
            shape_name


def _jax_flops(cfg, shape_name: str) -> float:
    """The reference's lowered cost of the unsharded cell in
    ``benchmarks/roofline.py``'s exact-cost mode (loops unrolled)."""
    shape = JSHAPES[shape_name]
    sp = jspecs.input_specs(cfg, shape_name, 1)
    qc = min(8192, shape.seq_len)
    if shape.kind == "train":
        def fn(params, batch):
            return jax.value_and_grad(lambda p: JM.train_fwd(
                p, batch, cfg, tp=1, q_chunk=qc, kv_chunk=qc,
                unroll=True))(params)
    else:
        def fn(params, batch):
            return JM.prefill(params, batch, cfg, cache_len=shape.seq_len,
                              tp=1, q_chunk=qc, kv_chunk=qc, unroll=True)
    lowered = jax.jit(fn).lower(sp["params"], sp["batch"])
    return float(lowered.cost_analysis()["flops"])


@pytest.mark.parametrize("name,shape_name,lo", [
    ("yi-34b", "train_4k", 0.90), ("yi-34b", "prefill_32k", 0.90),
    ("phi3.5-moe-42b-a6.6b", "train_4k", 0.50),
    ("mamba2-130m", "train_4k", 0.90)])
def test_flops_match_cost_analysis(name, shape_name, lo):
    """The dry-run's assembled count of the unsharded reduced cell against
    XLA's, within the module docstring's tolerance."""
    jcfg = jarchs.reduced_config(jarchs.get_arch(name))
    f1, f2 = (_jax_flops(dataclasses.replace(jcfg, n_layers=n), shape_name)
              for n in (1, 2))
    want = f1 + (jcfg.n_layers - 1) * (f2 - f1)
    got = D.layer_assembled_flops(name, shape_name,
                                  make_mesh((1, 1), ("data", "model")),
                                  cfg=reduced_config(get_arch(name)))
    assert lo * want <= got <= want, got / want


def test_collectives_on_a_hand_worked_cell():
    """2 layers, d_model 64, 4 heads, d_ff 128, vocab 256 on a 2x2 mesh,
    train_4k (batch 256 x 4096: 524,288 tokens a device). f32 shards a
    device: wq / wk / wv / attn wo 4,096 B a layer, mlp wi / wg / wo 8,192,
    tok / unembed 16,384, ln1 / ln2 256 a layer, ln_f 256.
      all-gather: (4 x 4,096 + 3 x 8,192) x 2 (data) x 2 layers x 2
        passes + 2 x 16,384 x 2 x 2 = 458,752 B in 32;
      reduce-scatter: (4 x 4,096 + 3 x 8,192) x 2 + 2 x 16,384 = 114,688
        B in 16;
      all-reduce: the norms' gradients 256 x 2 x 2 + 256 = 1,280 B in 5,
        and the two row-parallel wo outputs, 524,288 x 64 x 2 B, twice a
        layer (forward, backward) over 2 layers: 8 x 67,108,864 B."""
    cfg = ArchConfig(name="hand", family="dense", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=4, d_ff=128, vocab=256)
    mesh = make_mesh((2, 2), ("data", "model"))
    params = S.param_specs(cfg, 2)
    got = D.collectives(cfg, "train_4k", mesh, params,
                        sh.param_shardings(params, mesh))
    assert got["bytes"] == {"all-gather": 458752, "reduce-scatter": 114688,
                            "all-reduce": 1280 + 8 * 67108864,
                            "all-to-all": 0, "collective-permute": 0}
    assert got["counts"] == {"all-gather": 32, "reduce-scatter": 16,
                             "all-reduce": 13, "all-to-all": 0,
                             "collective-permute": 0}
    assert got["total_bytes"] == sum(got["bytes"].values())
    one = make_mesh((1, 1), ("data", "model"))
    params1 = S.param_specs(cfg, 1)
    none = D.collectives(cfg, "train_4k", one, params1,
                         sh.param_shardings(params1, one))
    assert none["total_bytes"] == 0 and not any(none["counts"].values())


def test_moe_cell_has_expert_all_to_alls():
    """EP: two all-to-alls a MoE layer forward, two more backward, on the
    production mesh (experts over 'data'); a prefill has the forward's."""
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    cfg = get_arch("phi3.5-moe-42b-a6.6b")
    params = S.param_specs(cfg, 16)
    for shape_name, per_layer in (("train_4k", 4), ("prefill_32k", 2)):
        got = D.collectives(cfg, shape_name, mesh, params,
                            sh.param_shardings(params, mesh))
        assert got["counts"]["all-to-all"] == per_layer * cfg.n_layers
        shape = SHAPES[shape_name]
        tokens = shape.global_batch // 16 * shape.seq_len
        assert got["bytes"]["all-to-all"] == per_layer * cfg.n_layers * int(
            tokens * cfg.moe.top_k * cfg.moe.capacity_factor
            * cfg.d_model * 2)


def test_cli_all_cells_both_meshes(cli_run):
    """``--all --mesh both``: one record per runnable cell and mesh, with
    the reference's keys; the multi-pod record holds half the single-pod
    FLOPs a device; nothing compiled."""
    proc, out = cli_run
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    cells = [(a, s) for a in ARCHS for s in SHAPES
             if runnable(get_arch(a), s)]
    paths = sorted(out.glob("*.json"))
    assert len(paths) == 2 * len(cells) == len(
        [ln for ln in stdout.splitlines() if ln.startswith("OK ")])
    for arch, shape_name in cells:
        recs = {mk: json.loads((out / f"{arch}__{shape_name}__{mk}.json")
                               .read_text()) for mk in ("single", "multi")}
        for mk, r in recs.items():
            assert set(r) == RECORD_KEYS
            assert MEMORY_KEYS <= set(r["memory"])
            assert set(r["collectives"]) == {"bytes", "counts",
                                             "total_bytes"}
            assert set(r["collectives"]["bytes"]) == COLLECTIVES
            assert r["devices"] == (256 if mk == "single" else 512)
            assert r["compile_s"] is None
            assert r["memory"]["temp_size_in_bytes"] is None
            assert r["flops"] > 0 and r["memory"][
                "argument_size_in_bytes"] > 0
        assert recs["multi"]["flops"] == pytest.approx(
            recs["single"]["flops"] / 2, rel=1e-12)
    assert "dry-run complete" in stdout
