"""Multi-device dry-run: what every (architecture x input shape) cell needs
per device, without a device.

Port of ``repro.launch.dryrun``. For each cell it builds the step (the
train step, prefill or one decode step) with its in / out shardings
(``distributed.sharding`` on ``launch.mesh``'s meshes: the single-pod
(16 data x 16 model = 256 devices) and the multi-pod (2 pods x 16 x 16 =
512 devices) layout) over ``launch.specs``' stand-ins, and records one
JSON record with the reference's keys into ``--out``
(``build/dryrun/<arch>__<shape>__<mesh>.json`` by default):

  * ``memory.argument_size_in_bytes`` / ``output_size_in_bytes``: one
    device's bytes of the step's inputs and outputs under the shardings,
    exact, summed over every leaf's ``NamedSpec.shard_shape``
    (``memory.argument_bytes_by_part`` splits the inputs by argument);
  * ``flops``: the step's FLOPs per device: ``FlopCounterMode`` over the
    step run under ``FakeTensorMode`` (nothing is allocated or computed),
    at ``n_layers`` = 1 and 2, assembled as ``f1 + (L - 1) (f2 - f1)``
    (the method of ``benchmarks/roofline.py``), divided by the number of
    devices (every sharded product splits evenly over the mesh);
  * ``collectives``: bytes (each op's result bytes on one device, the
    reference's proxy) and counts by the reference's five kinds, from a
    model of the placements, not a compile's count:
      - all-gather: FSDP gathers of every 'data'-sharded parameter on use,
        one a layer for a stacked leaf (once for the others), again in the
        backward of a train step; bytes: the leaf's shard with its 'data'
        split undone;
      - reduce-scatter (train): the gradient of every 'data'-sharded
        parameter, over 'data', one a layer; bytes: its shard; with
        'pod' in the mesh it is also all-reduced over 'pod' (bytes: its
        shard);
      - all-reduce: the gradient of every parameter not split over 'data'
        (train), over the batch axes, bytes its shard; and the TP
        all-reduce of each row-parallel output (``wo`` / ``w_out`` whose
        contracted dim is split over 'model'), one a layer, again in the
        backward: bytes the layer output on one device (tokens of the
        device's batch shard x d_model, bf16; MoE experts' ``wo``: the
        routed copies, x top_k);
      - all-to-all: EP dispatch and combine of every MoE layer whose
        experts are split over 'data', two a layer, again in the
        backward; bytes: tokens x top_k x capacity_factor x d_model, bf16;
      - collective-permute: none (no pipeline stage or ring);
    an axis of size 1 moves nothing.

Deviations from the reference, which lowers and compiles each cell with
XLA: nothing is compiled, so ``memory.temp_size_in_bytes``,
``memory.generated_code_size_in_bytes`` and ``compile_s`` are null;
``bytes_accessed`` is the argument plus output bytes (a lower bound of a
device's HBM traffic, not XLA's count); ``flops`` counts the products
(matmuls, einsums) ``FlopCounterMode`` sees, not XLA's elementwise
operations; ``lower_s`` is the seconds to build and count the cell.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import time
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.shapes import SHAPES, runnable
from repro_torch.distributed import sharding as sh
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh, tp_width
from repro_torch.models import model as M
from repro_torch.models.archs import ARCHS, get_arch
from repro_torch.models.model import TensorSpec
from repro_torch.training import train_step as ts

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_BF16 = 2
# the step's arguments by cell kind, in build_cell's order
_ARG_NAMES = {"train": ("params", "opt_state", "batch"),
              "prefill": ("params", "batch"),
              "decode": ("params", "cache", "batch", "pos")}


# ---------------------------------------------------------------------------
# trees of stand-ins
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    """Leaves of a tree of dicts / ``Cache``s / ``TensorSpec``s or
    ``NamedSpec``s, in insertion order (both trees of a cell share it)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, M.Cache):
        return [x for f in M.FIELDS for x in _leaves(getattr(tree, f))]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, TensorSpec):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, M.Cache):
        return M.Cache(**{f: _map(fn, getattr(tree, f)) for f in M.FIELDS})
    return fn(tree)


@functools.lru_cache(maxsize=None)
def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def sharded_bytes(specs, shardings) -> int:
    """One device's bytes of a tree of stand-ins under its shardings."""
    a, b = _leaves(specs), _leaves(shardings)
    if len(a) != len(b):
        raise ValueError(f"{len(a)} leaves against {len(b)} shardings")
    return sum(math.prod(s.shard_shape(t.shape)) * _itemsize(t.dtype)
               for t, s in zip(a, b))


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------


def build_cell(arch: str, shape_name: str, mesh, n_micro: int = 1,
               cfg=None, chunk: int | None = None):
    """Returns (fn, example_args tuple of ``TensorSpec`` trees,
    in_shardings, (outputs, out_shardings)). ``cfg`` overrides the arch's
    config (the dry-run's per-layer counts, a reduced config); ``chunk``
    the attention's q / kv chunk (the steps' default, 1024, when None)."""
    cfg = cfg or get_arch(arch)
    qkv = {} if chunk is None else {"q_chunk": chunk, "kv_chunk": chunk}
    shape = SHAPES[shape_name]
    tp = tp_width(mesh)
    specs = S.input_specs(cfg, shape_name, tp)

    if shape.kind == "train":
        # microbatching bounds the per-device activation footprint
        step = ts.build_train_step(cfg, tp=tp, n_micro=n_micro, **qkv)

        def fn(params, opt_state, batch):
            return step(params, opt_state, batch)[:3]
        args = (specs["params"], specs["opt_state"], specs["batch"])
        in_sh = (sh.param_shardings(specs["params"], mesh),
                 sh.opt_state_shardings(specs["opt_state"], mesh),
                 sh.batch_shardings(specs["batch"], mesh))
        scalar = TensorSpec((), torch.float32)
        out = (specs["params"], specs["opt_state"],
               {"loss": scalar, "grad_norm": scalar, "lr": scalar})
        out_sh = (in_sh[0], in_sh[1],
                  {k: sh.replicated(mesh) for k in out[2]})
    elif shape.kind == "prefill":
        fn = functools.partial(_prefill_fn, cfg=cfg, tp=tp,
                               cache_len=shape.seq_len, **qkv)
        args = (specs["params"], specs["batch"])
        cache_sds = M.cache_spec(cfg, shape.global_batch, shape.seq_len, tp)
        logits = TensorSpec((shape.global_batch, 1, cfg.padded_vocab(tp)),
                            torch.bfloat16)
        in_sh = (sh.param_shardings(specs["params"], mesh),
                 sh.batch_shardings(specs["batch"], mesh))
        out = (logits, cache_sds)
        out_sh = (sh.batch_shardings(logits, mesh),
                  sh.cache_shardings(cache_sds, mesh, cfg))
    else:  # decode
        long_ctx = shape_name == "long_500k"
        fn = functools.partial(_decode_fn, cfg=cfg, tp=tp)
        args = (specs["params"], specs["cache"], specs["batch"],
                specs["pos"])
        logits = TensorSpec((shape.global_batch, 1, cfg.padded_vocab(tp)),
                            torch.bfloat16)
        cache_sh = sh.cache_shardings(specs["cache"], mesh, cfg,
                                      long_context=long_ctx)
        in_sh = (sh.param_shardings(specs["params"], mesh),
                 cache_sh,
                 sh.batch_shardings(specs["batch"], mesh),
                 sh.replicated(mesh))
        out = (logits, specs["cache"])
        out_sh = (sh.batch_shardings(logits, mesh), cache_sh)
    return fn, args, in_sh, (out, out_sh)


def _prefill_fn(params, batch, *, cfg, tp, cache_len, **qkv):
    return M.prefill(params, batch, cfg, cache_len=cache_len, tp=tp, **qkv)


def _decode_fn(params, cache, batch, pos, *, cfg, tp):
    return M.decode_step(params, cache, batch, pos, cfg, tp=tp)


# ---------------------------------------------------------------------------
# FLOPs: the step under FakeTensorMode
# ---------------------------------------------------------------------------


def _fake(spec: TensorSpec):
    return torch.zeros(spec.shape, dtype=spec.dtype)


# the attention chunk of the counting run: the port's chunked attention
# computes every (q, kv) chunk pair, so the count is the step's at any
# chunk, and larger chunks take fewer fake ops (as benchmarks/roofline.py)
COUNT_CHUNK = 8192


def step_flops(arch: str, shape_name: str, mesh, n_micro: int = 1,
               cfg=None) -> float:
    """The FLOPs of one run of the cell's step (all devices together),
    counted by ``FlopCounterMode`` on fake tensors."""
    shape = SHAPES[shape_name]
    fn, args, _, _ = build_cell(arch, shape_name, mesh, n_micro, cfg,
                                chunk=min(COUNT_CHUNK, shape.seq_len))
    with FakeTensorMode():
        inputs = [_map(_fake, a) for a in args]
        if shape.kind == "decode":
            inputs[-1] = shape.seq_len - 1          # pos: the cache's end
        with FlopCounterMode(display=False) as counter:
            fn(*inputs)
    return float(counter.get_total_flops())


def layer_assembled_flops(arch: str, shape_name: str, mesh,
                          n_micro: int = 1, cfg=None) -> float:
    """Total FLOPs of the full-depth step from the counts at n_layers = 1
    and 2: f1 + (L - 1) * (f2 - f1)."""
    if cfg is None:
        return _arch_flops(arch, shape_name, tp_width(mesh), n_micro)
    return _assembled(arch, shape_name, mesh, n_micro, cfg)


@functools.lru_cache(maxsize=None)
def _arch_flops(arch: str, shape_name: str, tp: int, n_micro: int):
    """The count depends on the mesh only through its TP width."""
    from repro_torch.launch.mesh import make_mesh
    return _assembled(arch, shape_name, make_mesh((1, tp), ("data", "model")),
                      n_micro, get_arch(arch))


def _assembled(arch, shape_name, mesh, n_micro, cfg) -> float:
    f1, f2 = (step_flops(arch, shape_name, mesh, n_micro,
                         dataclasses.replace(cfg, n_layers=n))
              for n in (1, 2))
    return f1 + (cfg.n_layers - 1) * max(f2 - f1, 0.0)


# ---------------------------------------------------------------------------
# Collectives: a model of the placements (module docstring)
# ---------------------------------------------------------------------------


def _path_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _path_leaves(v, path + (str(k),))]
    return [(path, tree)]


def _axis_split(mesh, spec, axis: str) -> int:
    """How many ways ``spec`` splits a tensor over mesh axis ``axis``."""
    sizes = sh.mesh_axes(mesh)
    for entry in spec:
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        if axis in names:
            return sizes[axis]
    return 1


def collectives(cfg, shape_name: str, mesh, params, param_sh) -> dict:
    """{"bytes", "counts", "total_bytes"} of one device's collectives in
    one run of the cell's step, by the rules of the module docstring."""
    shape = SHAPES[shape_name]
    sizes = sh.mesh_axes(mesh)
    train = shape.kind == "train"
    passes = 2 if train else 1                  # forward (+ backward)
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}

    def add(kind, nbytes, n):
        out[kind] += int(nbytes) * int(n)
        counts[kind] += int(n)

    ba_ways = sh.axis_size(mesh, sh.batch_axes(mesh))
    batch_ways = 1 if shape.global_batch % ba_ways else ba_ways
    s_in = 1 if shape.kind == "decode" else shape.seq_len
    tokens = shape.global_batch // batch_ways * s_in
    d = cfg.d_model
    pod = sizes.get("pod", 1)

    for (path, leaf), ns in zip(_path_leaves(params),
                                _leaves(param_sh)):
        n = cfg.n_layers if path[0] == "layers" else 1
        shard = math.prod(ns.shard_shape(leaf.shape)) * _itemsize(leaf.dtype)
        per = shard // n                       # one layer's shard
        split = _axis_split(mesh, ns.spec, "data")
        if split > 1:
            add("all-gather", per * split, n * passes)
            if train:
                add("reduce-scatter", per, n)
                if pod > 1:
                    add("all-reduce", per, n)
        elif train and ba_ways > 1:
            add("all-reduce", per, n)
        key = path[-1]
        contracted = ns.spec[-2] if len(ns.spec) >= 2 else None
        if key in ("wo", "w_out") and sizes.get("model", 1) > 1 and (
                contracted == "model"):
            routed = ("moe" in path and "shared" not in path
                      and len(leaf.shape) >= 3 + (path[0] == "layers"))
            k = cfg.moe.top_k if routed else 1
            add("all-reduce", tokens * k * d * _BF16, n * passes)
        if key == "wi" and "moe" in path and "shared" not in path \
                and split > 1:
            m = cfg.moe
            nbytes = tokens * m.top_k * m.capacity_factor * d * _BF16
            add("all-to-all", nbytes, 2 * n * passes)
    return {"bytes": out, "counts": counts,
            "total_bytes": sum(out.values())}


# ---------------------------------------------------------------------------
# Dry-run one cell
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             save: bool = True, n_micro: int = 1, out_dir=None,
             mesh=None) -> dict:
    """One record; ``mesh`` overrides the production mesh of
    ``mesh_kind`` (a one-device (1, 1) mesh, a test's 4 x 4)."""
    mesh = mesh or make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.time()
    cfg = get_arch(arch)
    fn, args, in_sh, (out, out_sh) = build_cell(arch, shape_name, mesh,
                                                n_micro)
    parts = _ARG_NAMES[SHAPES[shape_name].kind]
    by_part = {p: sharded_bytes(a, s)
               for p, a, s in zip(parts, args, in_sh)}
    out_bytes = sharded_bytes(out, out_sh)
    n_dev = math.prod(sh.mesh_axes(mesh).values())
    flops = layer_assembled_flops(arch, shape_name, mesh, n_micro) / n_dev
    coll = collectives(cfg, shape_name, mesh, args[0], in_sh[0])
    arg_bytes = sum(by_part.values())
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "devices": n_dev, "n_micro": n_micro,
        "flops": flops,
        "bytes_accessed": float(arg_bytes + out_bytes),
        "collectives": coll,
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": None,
                   "generated_code_size_in_bytes": None,
                   "alias_size_in_bytes": 0,
                   "argument_bytes_by_part": by_part},
        "lower_s": round(time.time() - t0, 2), "compile_s": None,
    }
    if save:
        out_dir = Path(out_dir) if out_dir is not None else RESULTS_DIR
        out_dir.mkdir(parents=True, exist_ok=True)
        micro_tag = f"__micro{n_micro}" if n_micro > 1 else ""
        path = out_dir / f"{arch}__{shape_name}__{mesh_kind}{micro_tag}.json"
        path.write_text(json.dumps(result, indent=1))
    return result


def iter_cells():
    for arch, cfg in ARCHS.items():
        for shape_name in SHAPES:
            if runnable(cfg, shape_name):
                yield arch, shape_name


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--micro", type=int, default=1,
                    help="gradient-accumulation microbatches (train cells)")
    ap.add_argument("--out", default=None,
                    help=f"directory of the records (default {RESULTS_DIR})")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = (list(iter_cells()) if args.all
             else [(args.arch, args.shape)])
    records = []
    for arch, shape_name in cells:
        for mk in meshes:
            r = run_cell(arch, shape_name, mk, n_micro=args.micro,
                         out_dir=args.out)
            records.append(r)
            print(f"OK   {arch} x {shape_name} x {mk}: "
                  f"flops={r['flops']:.3e} "
                  f"args={r['memory']['argument_size_in_bytes']:.3e}B "
                  f"coll={r['collectives']['total_bytes']:.3e}B "
                  f"build={r['lower_s']}s", flush=True)
    print(f"dry-run complete: {len(records)} records, nothing compiled")
    return records


if __name__ == "__main__":
    main()
