"""Multi-pod dry-run (counterpart of ``repro/launch/dryrun.py``): build
every (architecture x input-shape) cell on the production meshes and
count per-device FLOPs, bytes, collectives and memory.

The reference lowers and compiles each cell for 512 fake host devices and
reads XLA's cost and memory analyses.  Torch has no such analyses, so the
port RUNS the cell's step eagerly on fake tensors (``FakeTensorMode``:
shapes and dtypes, no storage, no arithmetic) over a ``fake`` process
group of 256 or 512 ranks (``torch.testing._internal.distributed.
fake_pg``, the group torchtitan's memory estimator uses), with the
parameters, optimizer state, batch and cache as ``DTensor``s placed by
``parallel/sharding.py``, and counts what rank 0 does.  One dispatch mode
sees every op on the local shards (inside DTensor's dispatch, where the
op runs on local tensors; DTensor's own shape propagation is not
counted):

- ``flops``: the matrix products and convolutions, by
  ``torch.utils.flop_counter``'s formulas on local shapes;
- ``bytes_accessed``: each op's local inputs read and outputs written
  (views and metadata ops excluded) — the unfused traffic of eager
  execution, not XLA's fused figure;
- ``collective``: the functional collectives DTensor issues (and
  ``compressed_mean``'s), result bytes, wire bytes by the reference's
  ring formulas (``collective_stats``) and counts, per kind;
- ``peak_bytes``: the most local bytes live at once, arguments included
  (a storage counts from the op that makes it until it is freed).

These are the port's own estimates: not XLA's numbers and not
measurements of a chip.  Layer stacks are homogeneous, so each count is
affine in the depth L: two reduced-depth probes are run and extrapolated
(``argument_bytes`` alone is computed at full depth, exactly: the sum of
rank 0's local shards); ``--full-unroll`` runs every layer instead.
``cfg.unroll`` changes nothing in eager torch, which runs every loop as
written, so the reference's loop-free ``_unrolled_causal_attention`` has
no counterpart.  This is the one module of the port that imports the
fake process group; it never touches a device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape decode_32k --mesh single [--out artifacts/dryrun] [overrides]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.common import hw
from repro_torch.common.types import SHAPES_BY_NAME, ParallelConfig, TrainConfig
from repro_torch.configs.registry import ALIASES, get as get_config, get_smoke
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import cache_specs, cell_is_applicable, input_specs
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import lm as LM
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as Sh
from repro_torch.parallel.ctx import mesh_axes

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collective op -> kind (ops of _c10d_functional and _dtensor)
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
          "all_reduce_coalesced": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all",
          "broadcast": "collective-permute"}

# ops that move no bytes of their own
_FREE = {"empty", "empty_strided", "empty_like", "detach", "alias", "view",
         "_unsafe_view", "t", "transpose", "permute", "expand", "select",
         "slice", "unsqueeze", "squeeze", "as_strided", "split",
         "split_with_sizes", "unbind", "chunk", "wait_tensor", "lift_fresh",
         "_to_copy_meta", "set_", "resize_", "device", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "dim", "numel",
         "is_same_size", "_local_scalar_dense"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Tally:
    """Rank 0's local counts of one run: flops, bytes, collectives (result
    and wire bytes, counts by kind) and live / peak bytes."""

    def __init__(self, fake_mode):
        from torch.utils.flop_counter import flop_registry
        self.fake_mode = fake_mode
        self.flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.res = dict.fromkeys(COLLECTIVES, 0)
        self.wire = dict.fromkeys(COLLECTIVES, 0)
        self.counts = dict.fromkeys(COLLECTIVES, 0)
        self.live = 0
        self.peak = 0
        self._held = {}
        # DTensor ops DTensor could not place as they came: op -> retries
        self.fallbacks = collections.Counter()

    def hold(self, t):
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._held.pop(key, 0)

    def local(self, ts) -> bool:
        """Rank 0's own tensors (ours, not DTensor's shape propagation)."""
        return all(getattr(t, "fake_mode", None) is self.fake_mode
                   for t in ts)

    def op(self, func, args, kwargs, out):
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not self.local(ins + outs):
            return
        for t in outs:
            self.hold(t)
        name = func.overloadpacket.__name__
        kind = _KINDS.get(name) if func.namespace in (
            "_c10d_functional", "c10d_functional", "_dtensor") else None
        if kind is not None:
            b = sum(_nbytes(t) for t in outs)
            self.res[kind] += b
            self.counts[kind] += 1
            if kind == "all-reduce":
                self.wire[kind] += 2 * b
            elif kind == "reduce-scatter":
                size = next((a for a in args[1:] if isinstance(a, int)), 2)
                self.wire[kind] += b * size
            else:
                self.wire[kind] += b
            return
        f = self.flop_registry.get(func.overloadpacket)
        if f is not None:
            self.flops += f(*args, **kwargs, out_val=out)
        if name not in _FREE and not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)

    def costs(self):
        res, wire = dict(self.res), dict(self.wire)
        res["total"] = sum(res[k] for k in COLLECTIVES)
        wire["total"] = sum(wire[k] for k in COLLECTIVES)
        return dict(flops=self.flops, bytes=self.bytes, coll_wire=wire,
                    coll_res=res, counts=dict(self.counts), peak=self.peak,
                    fallbacks=dict(self.fallbacks))


def _has_dtensor(args, kwargs) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(a, DTensor) for a in tree_flatten((args,
                                                             kwargs))[0])


def _keep_batch(t):
    """Placements keeping shards of dim 0 (the batch), replicating the
    rest."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in t.placements]


def _replicate(t):
    from torch.distributed.tensor import Replicate
    return [Replicate()] * len(t.placements)


def _relaxed(relax, args, kwargs):
    """(args, kwargs) with every DTensor redistributed to ``relax(t)``'s
    placements (the collectives are counted: call under ``_Local``)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_map_only
    return tree_map_only(DTensor, lambda t: t.redistribute(
        t.device_mesh, relax(t)), (args, kwargs))


class _Local(TorchDispatchMode):
    """Active inside DTensor's dispatch: passes DTensor ops on (so that
    DTensor runs them) and counts the local ops DTensor makes on rank 0's
    shards.  DTensor's own small host tensors (shard offsets) run as they
    are: the ``FakeTensorMode`` is lifted around a DTensor op, and a fake
    shard's ops find their mode through the shard itself."""

    def __init__(self, tally):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(args, kwargs):
            return NotImplemented
        out = func(*args, **kwargs)
        self.tally.op(func, args, kwargs, out)
        return out


class Counting(TorchDispatchMode):
    """Counts every local op of a run into ``tally``: plain ops here, a
    DTensor op's local ops under ``_Local`` while DTensor runs it."""

    def __init__(self, tally):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import (FakeTensor,
                                                   unset_fake_temporarily)
        kwargs = kwargs or {}
        if _has_dtensor(args, kwargs):
            for relax in (None, _keep_batch, _replicate):
                with unset_fake_temporarily(), _Local(self.tally):
                    if relax is not None:
                        self.tally.fallbacks[str(func)] += 1
                        args, kwargs = _relaxed(relax, args, kwargs)
                    try:
                        return func(*args, **kwargs)
                    except (RuntimeError, NotImplementedError,
                            AssertionError):    # no strategy for these
                        if relax is _replicate:
                            raise
        ts = _tensors((args, kwargs))
        if (func.overloadpacket is torch.ops.aten.arange
                or (ts and not any(isinstance(t, FakeTensor) for t in ts))):
            # real index vectors and what is made of them: DTensor reads
            # shard offsets from one (.tolist()), and the model's are at
            # most a sequence long
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self.tally.op(func, args, kwargs, out)
        return out


def model_flops(cfg, shape):
    """(useful_flops_global, params_total, params_active)."""
    defs = LM.build_defs(cfg)
    total = 0
    active = 0.0
    for name, d in defs.items():
        n = int(np.prod(d.shape))
        total += n
        if cfg.moe and name.startswith("layers/e_"):
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * active * tokens, total, active


# ------------------------------------------------------------ the mesh --

def fake_group(world: int):
    """A ``fake`` process group of ``world`` ranks, this process rank 0
    (an existing group of another size is replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(mesh_kind: str, shape=None):
    """The production mesh of ``mesh_kind`` on a fake group, or a mesh of
    ``shape`` (a tuple over ("data", "model"), or ("pod", "data",
    "model") with three dims) for small runs."""
    from torch.distributed.device_mesh import init_device_mesh
    if shape is None:
        fake_group(512 if mesh_kind == "multi" else 256)
        return make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device_type="cpu")
    fake_group(math.prod(shape))
    names = ("pod", "data", "model")[-len(shape):]
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


def _dtensor(meta, spec, mesh):
    """A DTensor of ``meta``'s global shape and dtype placed by ``spec``,
    holding rank 0's local shard (a fake tensor: build it under the
    ``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = Sh.placements(spec, mesh)
    shape = tuple(meta.shape)
    with unset_fake_temporarily():
        local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(torch.empty(local, dtype=meta.dtype), mesh, pl,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _place(metas, specs, mesh):
    return {n: _dtensor(m, specs[n], mesh) for n, m in metas.items()}


def _local_bytes(metas, specs, mesh) -> int:
    """Rank 0's bytes of these tensors placed by ``specs``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    total = 0
    for n, m in metas.items():
        local, _ = compute_local_shape_and_global_offset(
            tuple(m.shape), mesh, Sh.placements(specs[n], mesh))
        total += math.prod(local) * m.element_size()
    return total


def cell_arguments(cfg, shape, mesh, plan):
    """(meta tensors, specs) of every argument of the cell's step, by
    group: params, opt (train), batch, cache (decode)."""
    metas = {"params": LM.abstract_params(cfg),
             "batch": input_specs(cfg, shape)}
    p_sh = Sh.param_shardings(cfg, mesh)
    specs = {"params": p_sh, "batch": Sh.batch_shardings(cfg, shape, mesh)}
    if shape.kind == "train":
        md = plan.parallel.moment_dtype
        st = adamw.abstract_state(metas["params"], md)
        sh = adamw.state_shardings(p_sh, mesh, md)
        for f in ("m", "m_scale", "v", "v_scale"):
            metas[f"opt/{f}"], specs[f"opt/{f}"] = getattr(st, f), getattr(
                sh, f)
        metas["opt/step"], specs["opt/step"] = {"step": st.step}, {
            "step": sh.step}
    elif shape.kind == "decode":
        metas["cache"] = cache_specs(cfg, shape)
        specs["cache"] = Sh.cache_shardings(cfg, shape.global_batch,
                                            shape.seq_len, mesh)
    return metas, specs


def argument_bytes(cfg, shape, mesh, plan) -> int:
    metas, specs = cell_arguments(cfg, shape, mesh, plan)
    return sum(_local_bytes(metas[g], specs[g], mesh) for g in metas)


def build_cell(cfg, shape, mesh, plan):
    """(step function, its arguments as DTensors); call under the
    ``FakeTensorMode``."""
    metas, specs = cell_arguments(cfg, shape, mesh, plan)
    args = {g: _place(metas[g], specs[g], mesh) for g in metas}
    params, batch = args["params"], args["batch"]
    if shape.kind == "train":
        opt = adamw.AdamWState(args["opt/step"]["step"],
                               *(args[f"opt/{f}"] for f in
                                 ("m", "m_scale", "v", "v_scale")))
        fn = make_train_step(cfg, plan.parallel, TrainConfig())
        return fn, (params, opt, batch)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, plan.parallel), (params, batch)
    return make_serve_step(cfg), (params, args["cache"], batch)


def run_counted(cfg, shape, mesh, plan):
    """Build the cell on fake DTensors and run its step once under
    ``Counting``; returns (Tally.costs(), argument bytes, output bytes,
    bytes of outputs that alias arguments)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    # DTensor's own small host tensors (scalars it fills with) meet the
    # fake shards while the mode is lifted: let them in
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    tally = Tally(fake)
    with fake, mesh_axes(mesh.mesh_dim_names), implicit_replication():
        fn, args = build_cell(cfg, shape, mesh, plan)
        held = [t.to_local() for t in _tensors(args)]
        for t in held:
            tally.hold(t)
        arg_bytes = tally.live
        grad = torch.enable_grad() if shape.kind == "train" \
            else torch.no_grad()
        with grad, Counting(tally):
            out = fn(*args)
        keys = {t.untyped_storage()._cdata for t in held}
        outs = [t.to_local() if hasattr(t, "to_local") else t
                for t in _tensors(out)]
        out_bytes = sum(_nbytes(t) for t in outs)
        alias = sum(_nbytes(t) for t in outs
                    if t.untyped_storage()._cdata in keys)
        del out, fn, args, held, outs
    return tally.costs(), arg_bytes, out_bytes, alias


def _probe_layer_counts(cfg):
    if cfg.family == "hybrid":
        return cfg.hybrid.attn_every, 2 * cfg.hybrid.attn_every
    return 2, 4


def _lin(x1, v1, x2, v2, x):
    """The affine function through (x1, v1), (x2, v2), at x."""
    return v1 + (x - x1) * (v2 - v1) / (x2 - x1)


def unrolled_costs(cfg, shape, mesh, plan, full_unroll=False):
    """Per-device flops / bytes / collectives / peak of the step.

    Layer stacks are homogeneous, so each count is affine in the depth L;
    microbatches are identical, so it is affine in their number k too (k
    >= 2, the accumulating loop).  Probes at two depths (and, past two
    microbatches, at k = 2 and 3 of the same microbatch size) are run and
    extrapolated to (n_layers, microbatch) — the reference's method for
    its loop-free modules, here to spare eager steps of 94 layers x 16
    microbatches.  The peak is taken at k = 2 (more microbatches add no
    live bytes).  ``--full-unroll`` runs the whole step instead."""
    mb = plan.microbatch
    rows = shape.global_batch // mb

    def one(L, k):
        c = dataclasses.replace(cfg, n_layers=L)
        s = dataclasses.replace(shape, global_batch=rows * k)
        p = dataclasses.replace(plan, microbatch=k, parallel=dataclasses.
                                replace(plan.parallel, microbatch=k))
        costs, arg, out, alias = run_counted(c, s, mesh, p)
        return dict(costs, output=out, alias=alias)

    if full_unroll:
        return one(cfg.n_layers, mb), "full_unroll"
    Ls = _probe_layer_counts(cfg)
    ks = (2, 3) if mb > 2 else (mb,)
    runs = {(L, k): one(L, k) for L in Ls for k in ks}
    Lf = cfg.n_layers

    def at(get, k_to=mb):
        per_k = [_lin(Ls[0], get(runs[Ls[0], k]), Ls[1], get(runs[Ls[1], k]),
                      Lf) for k in ks]
        if len(ks) == 1:
            return per_k[0]
        return _lin(ks[0], per_k[0], ks[1], per_k[1], k_to)

    out = {k: at(lambda r: r[k]) for k in ("flops", "bytes", "output",
                                           "alias")}
    out["peak"] = at(lambda r: r["peak"], min(mb, 2))
    for k in ("coll_wire", "coll_res", "counts"):
        out[k] = {n: at(lambda r: r[k][n]) for n in runs[Ls[0], ks[0]][k]}
    out["fallbacks"] = runs[Ls[1], ks[-1]]["fallbacks"]
    method = f"probe_extrapolated_L{Ls[0]}_L{Ls[1]}"
    if len(ks) > 1:
        method += f"_mb{ks[0]}_mb{ks[1]}"
    return out, method


def run_cell(arch: str, shape_name: str, mesh_kind: str, outdir: str,
             overrides=None, tag="", smoke=False, mesh_shape=None):
    """One cell's record, written to ``outdir/<arch>__<shape>__<mesh>
    [__tag].json``.  For small runs (tests), ``smoke`` takes the
    architecture's smoke config, ``shape_name`` may be a ``ShapeConfig``
    and ``mesh_shape`` a small mesh in place of the production one."""
    t0 = time.time()
    mesh = make_mesh(mesh_kind, mesh_shape)
    n_chips = mesh.size()
    cfg = get_smoke(arch) if smoke else get_config(arch)
    shape = SHAPES_BY_NAME.get(shape_name, shape_name)
    shape_name = shape.name
    os.makedirs(outdir, exist_ok=True)
    stem = f"{ALIASES.get(arch, arch)}__{shape_name}__{mesh_kind}"
    if tag:
        stem += f"__{tag}"
    path = os.path.join(outdir, stem + ".json")
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_kind, chips=n_chips,
               status="skip", tag=tag)
    if not cell_is_applicable(cfg, shape):
        rec["reason"] = "long_500k requires sub-quadratic attention"
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"SKIP {arch} {shape_name} {mesh_kind}")
        return rec

    overrides = overrides or {}
    cfg_over = {k: v for k, v in overrides.items()
                if k in ("q_chunk", "kv_chunk")}
    par_over = {k: v for k, v in overrides.items()
                if k in ("remat", "microbatch", "moment_dtype", "seq_axis",
                         "moe_token_motion", "moe_arbitration_shards")}
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    parallel = ParallelConfig(**par_over) if par_over else None
    plan = Sh.make_plan(cfg, shape, mesh, parallel)
    arg_bytes = argument_bytes(cfg, shape, mesh, plan)
    t1 = time.time()

    costs, method = unrolled_costs(cfg, shape, mesh, plan,
                                   overrides.get("full_unroll", False))
    t2 = time.time()

    mf, n_total, n_active = model_flops(cfg, shape)
    flops = costs["flops"]
    bytes_accessed = costs["bytes"]
    coll = dict(wire_bytes=costs["coll_wire"], result_bytes=costs["coll_res"],
                counts=costs["counts"])
    compute_s = flops / hw.PEAK_FLOPS_BF16
    memory_s = bytes_accessed / hw.HBM_BW
    collective_s = coll["wire_bytes"]["total"] / hw.NVLINK_LINK_BW
    terms = dict(compute_s=compute_s, memory_s=memory_s,
                 collective_s=collective_s)
    dominant = max(terms, key=terms.get)
    mfd = mf / n_chips
    peak = costs["peak"]

    rec.update(
        status="ok",
        cost_method=method,
        estimates=("the port's fake-mesh estimates, rank 0: eager ops on "
                   "fake DTensor shards; not XLA's analyses, not a chip "
                   "measurement"),
        flops_method="torch.utils.flop_counter formulas on local shapes",
        bytes_method=("local inputs + outputs of every aten op (views "
                      "excluded): eager, unfused traffic"),
        peak_method=("live local storages under a dispatch mode, "
                     "arguments included"),
        # DTensor ops retried with dim-0 shards kept, the rest replicated
        # (then all replicated), in the largest probe
        fallback_ops=costs["fallbacks"],
        compile_scanned_s=round(t1 - t0, 1),
        compile_unrolled_s=round(t2 - t1, 1),
        microbatch=plan.microbatch, moment_dtype=plan.parallel.moment_dtype,
        remat=plan.parallel.remat,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        per_device=dict(
            flops=flops, bytes_accessed=bytes_accessed,
            collective=coll,
            argument_bytes=arg_bytes,
            output_bytes=costs["output"],
            temp_bytes=peak - arg_bytes,
            alias_bytes=costs["alias"],
            peak_bytes=peak,
        ),
        roofline=dict(
            **terms, dominant=dominant,
            model_flops_global=mf, params_total=n_total,
            params_active=n_active, model_flops_per_device=mfd,
            useful_ratio=mfd / max(flops, 1.0),
            step_time_lower_bound_s=max(terms.values()),
            mfu_bound=mfd / hw.PEAK_FLOPS_BF16 / max(max(terms.values()),
                                                     1e-30)),
    )
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"OK {arch} {shape_name} {mesh_kind}{' ' + tag if tag else ''}: "
          f"build={t1 - t0:.0f}s run={t2 - t1:.0f}s "
          f"flops/dev={flops:.3e} hbm/dev={bytes_accessed:.3e} "
          f"wire/dev={coll['wire_bytes']['total']:.3e} dom={dominant} "
          f"args={arg_bytes / 1e9:.2f}GB peak={peak / 1e9:.1f}GB "
          f"mfu_bound={rec['roofline']['mfu_bound']:.3f}", flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatch", type=int)
    ap.add_argument("--remat", choices=["none", "full", "dots"])
    ap.add_argument("--moment-dtype", choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--q-chunk", type=int)
    ap.add_argument("--kv-chunk", type=int)
    ap.add_argument("--full-unroll", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--token-motion", action="store_true")
    ap.add_argument("--moe-shards", type=int)
    args = ap.parse_args()
    overrides = {k: v for k, v in dict(
        microbatch=args.microbatch, remat=args.remat,
        moment_dtype=args.moment_dtype, q_chunk=args.q_chunk,
        kv_chunk=args.kv_chunk).items() if v is not None}
    if args.seq_parallel:
        overrides["seq_axis"] = "model"
    if args.token_motion:
        overrides["moe_token_motion"] = True
    if args.moe_shards:
        overrides["moe_arbitration_shards"] = args.moe_shards
    if args.full_unroll:
        overrides["full_unroll"] = True
    try:
        run_cell(args.arch, args.shape, args.mesh, args.out, overrides,
                 args.tag)
    except Exception:
        traceback.print_exc()
        rec = dict(arch=args.arch, shape=args.shape, mesh=args.mesh,
                   status="error", tag=args.tag,
                   error=traceback.format_exc()[-3000:])
        os.makedirs(args.out, exist_ok=True)
        stem = f"{ALIASES.get(args.arch, args.arch)}__{args.shape}__{args.mesh}"
        if args.tag:
            stem += f"__{args.tag}"
        with open(os.path.join(args.out, stem + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
