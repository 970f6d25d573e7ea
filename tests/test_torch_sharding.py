"""The port's logical-axis sharding (``parallel/sharding.py``), abstract
stand-ins and plans against the JAX package's, for all ten registry
configurations at full size.

JAX's ``spec_for`` reads only a mesh's ``axis_names`` and
``devices.shape``, so it gets a duck-typed mesh (no devices needed); its
``param_shardings`` / ``batch_shardings`` / ``cache_shardings`` wrap each
spec in ``NamedSharding``, which the tests replace with the identity to
read the specs.  The port's specs are plain tuples compared with JAX's
``PartitionSpec`` entry by entry.  The placements test builds a (2, 2, 2)
``("pod", "data", "model")`` mesh on a fake process group once per rank
and holds DTensor's local shape and offset at each rank coordinate
against the row-major (pod-major) block order of the JAX spec."""
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402

from repro.common.types import SHAPES as J_SHAPES  # noqa: E402
from repro.common.types import ParallelConfig as JParallel  # noqa: E402
from repro.configs.registry import get as j_get  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.parallel import sharding as JSh  # noqa: E402
from repro_torch.common.types import SHAPES, ParallelConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS, get  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.parallel import sharding as Sh  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _duck(mesh):
    shape, names = MESHES[mesh]
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _sizes(mesh):
    shape, names = MESHES[mesh]
    return dict(zip(names, shape))


@pytest.fixture
def jspecs(monkeypatch):
    """The reference's sharding functions with NamedSharding as the
    identity, so they return PartitionSpecs."""
    monkeypatch.setattr(JSh, "NamedSharding", lambda mesh, spec: spec)
    return JSh


def _same(tspec, jspec, what):
    assert isinstance(tspec, tuple), what
    assert tspec == tuple(jspec), (what, tspec, jspec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(jspecs, arch, mesh):
    """Every param def's spec, every cache entry's and every batch
    entry's (per shape kind) equal JAX's."""
    jcfg, tcfg = j_get(arch), get(arch)
    jm, tm = _duck(mesh), _sizes(mesh)
    jparams = JP.flatten(jspecs.param_shardings(jcfg, jm))
    tparams = Sh.param_shardings(tcfg, tm)
    assert set(jparams) == set(tparams)
    for n, d in TLM.build_defs(tcfg).items():
        _same(tparams[n], jparams[n], n)
        _same(Sh.spec_for(d.shape, d.axes, tm, tcfg),
              JSh.spec_for(d.shape, d.axes, jm, jcfg), n)
    for js, ts in zip(J_SHAPES, SHAPES):
        jb = jspecs.batch_shardings(jcfg, js, jm)
        tb = Sh.batch_shardings(tcfg, ts, tm)
        assert set(jb) == set(tb)
        for n in tb:
            _same(tb[n], jb[n], (ts.name, n))
        if ts.kind == "decode":
            jc = jspecs.cache_shardings(jcfg, js.global_batch, js.seq_len,
                                        jm)
            tc = Sh.cache_shardings(tcfg, ts.global_batch, ts.seq_len, tm)
            assert set(jc) == set(tc)
            for n in tc:
                _same(tc[n], jc[n], (ts.name, n))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_plans_match_jax(arch, mesh):
    """``auto_microbatch`` and ``make_plan`` for every shape, with and
    without a forced microbatch."""
    jcfg, tcfg = j_get(arch), get(arch)
    jm, tm = _duck(mesh), _sizes(mesh)
    for js, ts in zip(J_SHAPES, SHAPES):
        assert Sh.auto_microbatch(tcfg, ts, tm) == \
            JSh.auto_microbatch(jcfg, js, jm), ts.name
        for kw in (dict(), dict(microbatch=4), dict(remat="dots",
                                                   moment_dtype="bfloat16")):
            jp = JSh.make_plan(jcfg, js, jm, JParallel(**kw))
            tp = Sh.make_plan(tcfg, ts, tm, ParallelConfig(**kw))
            assert tp.microbatch == jp.microbatch
            assert dataclasses.asdict(tp.parallel) == \
                dataclasses.asdict(jp.parallel), (ts.name, kw)
            assert tp.describe() == jp.describe()


def _same_sds(t, j, what):
    assert t.device.type == "meta", what
    assert tuple(t.shape) == tuple(j.shape), what
    assert str(t.dtype) == f"torch.{np.dtype(j.dtype).name}", what


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_shapes_match_jax(arch):
    """``abstract_params``, ``abstract_state`` (float32, bf16 and int8
    moments), ``abstract_cache`` / ``cache_specs`` and ``input_specs``
    against JAX's ShapeDtypeStructs; the logical axes too."""
    jcfg, tcfg = j_get(arch), get(arch)
    jparams = JLM.abstract_params(jcfg)
    tparams = TLM.abstract_params(tcfg)
    jflat = JP.flatten(jparams)
    assert set(jflat) == set(tparams)
    for n, j in jflat.items():
        _same_sds(tparams[n], j, n)
    assert JP.flatten(JP.param_logical_axes(JLM.build_defs(jcfg))) == \
        TLM.P.param_logical_axes(TLM.build_defs(tcfg))
    for md in ("float32", "bfloat16", "int8"):
        js, ts = JA.abstract_state(jparams, md), TA.abstract_state(tparams,
                                                                   md)
        _same_sds(ts.step, js.step, "step")
        for f in ("m", "m_scale", "v", "v_scale"):
            for n, j in JP.flatten(getattr(js, f)).items():
                _same_sds(getattr(ts, f)[n], j, (md, f, n))
    assert TD.cache_logical_axes(tcfg) == JD.cache_logical_axes(jcfg)
    for js, ts in zip(J_SHAPES, SHAPES):
        assert TS.cell_is_applicable(tcfg, ts) == \
            JS.cell_is_applicable(jcfg, js)
        jb, tb = JS.input_specs(jcfg, js), TS.input_specs(tcfg, ts)
        assert set(jb) == set(tb)
        for n in tb:
            _same_sds(tb[n], jb[n], (ts.name, n))
        if ts.kind == "decode":
            jc, tc = JS.cache_specs(jcfg, js), TS.cache_specs(tcfg, ts)
            assert set(jc) == set(tc)
            for n in tc:
                _same_sds(tc[n], jc[n], (ts.name, n))


@pytest.mark.parametrize("md", ["float32", "int8"])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_state_shardings_match_jax(monkeypatch, md, mesh):
    """Moments placed like their params, scales as the reference places
    them (int8: the param's spec but the last dim; else replicated).
    JAX's NamedSharding is replaced by a holder of its spec."""
    holder = lambda mesh, spec: SimpleNamespace(spec=spec)
    monkeypatch.setattr(JSh, "NamedSharding", holder)
    monkeypatch.setattr(jax.sharding, "NamedSharding", holder)
    arch = "kimi_k2_1t_a32b"
    jm, tm = _duck(mesh), _sizes(mesh)
    jcfg, tcfg = j_get(arch), get(arch)
    js = JA.state_shardings(JSh.param_shardings(jcfg, jm), jm, md)
    ts = TA.state_shardings(Sh.param_shardings(tcfg, tm), tm, md)
    _same(ts.step, js.step.spec, "step")
    for f in ("m", "m_scale", "v", "v_scale"):
        jf = JP.flatten(getattr(js, f))
        assert set(jf) == set(getattr(ts, f))
        for n, j in jf.items():
            _same(getattr(ts, f)[n], j.spec, (f, n))


# ----------------------------------------------------------- placements --

PLACE_SIZES = {"pod": 2, "data": 2, "model": 2}


def _jax_block(shape, spec, coord):
    """(local shape, offset) of the device at ``coord`` ({axis: index})
    for a JAX spec: each dim split row-major over its axes, the first
    listed the major one."""
    local, off = [], []
    for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if part is None else (part if isinstance(part, tuple)
                                        else (part,))
        n = math.prod(PLACE_SIZES[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * PLACE_SIZES[a] + coord[a]
        local.append(dim // n)
        off.append(idx * (dim // n))
    return tuple(local), tuple(off)


def test_placements_follow_jax_block_order():
    """For every param of two smoke configs (with ("pod", "data") embed
    dims) and some cache entries, on a (2, 2, 2) mesh, at each of the 8
    rank coordinates."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro.configs.registry import get_smoke as j_get_smoke
    from repro_torch.configs.registry import get_smoke
    jm = SimpleNamespace(axis_names=("pod", "data", "model"),
                         devices=np.empty((2, 2, 2)))
    cases = []
    for arch in ("qwen3_moe_235b_a22b", "zamba2_2p7b"):
        cfg = dataclasses.replace(get_smoke(arch), d_model=64)
        jcfg = dataclasses.replace(j_get_smoke(arch), d_model=64)
        for n, d in TLM.build_defs(cfg).items():
            cases.append((n, d.shape,
                          Sh.spec_for(d.shape, d.axes, PLACE_SIZES, cfg),
                          JSh.spec_for(d.shape, d.axes, jm, jcfg)))
        for n, (s, _, a) in TD._normalize(TD.cache_spec(cfg, 4, 8)).items():
            cases.append((n, s, Sh.spec_for(s, a, PLACE_SIZES, cfg),
                          JSh.spec_for(s, a, jm, jcfg)))
    assert any(("pod", "data") in spec for _, _, spec, _ in cases)
    assert dist.is_available() and not dist.is_initialized()
    try:
        for rank in range(8):
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=8)
            mesh = init_device_mesh("cpu", (2, 2, 2),
                                    mesh_dim_names=("pod", "data", "model"))
            coord = dict(zip(("pod", "data", "model"), mesh.get_coordinate()))
            for n, shape, tspec, jspec in cases:
                assert tspec == tuple(jspec), n
                got = compute_local_shape_and_global_offset(
                    shape, mesh, Sh.placements(tspec, mesh))
                assert tuple(map(tuple, got)) == _jax_block(
                    shape, jspec, coord), (rank, n, tspec)
            dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
