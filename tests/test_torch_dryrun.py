"""The port's dry-run (``launch/dryrun.py``) on smoke configurations and
small fake meshes of 1, 4 and 8 ranks: the record's keys against the
reference's, argument bytes against the local shards of ``spec_for``,
per-device FLOPs under data parallelism, the probe extrapolation against
running every layer and microbatch, and no collective on one rank.

The fake process group is made by the dry-run and destroyed when the
module's tests are done (``--dist loadfile`` keeps them on one
worker)."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.common.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_smoke  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as Sh  # noqa: E402

TRAIN = ShapeConfig("t32", "train", 32, 8)

# the reference record's keys (repro/launch/dryrun.py::run_cell)
TOP = {"arch", "shape", "mesh", "chips", "status", "tag", "cost_method",
       "compile_scanned_s", "compile_unrolled_s", "microbatch",
       "moment_dtype", "remat", "q_chunk", "kv_chunk", "per_device",
       "roofline"}
PER_DEVICE = {"flops", "bytes_accessed", "collective", "argument_bytes",
              "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes"}
ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant",
            "model_flops_global", "params_total", "params_active",
            "model_flops_per_device", "useful_ratio",
            "step_time_lower_bound_s", "mfu_bound"}


@pytest.fixture(scope="module", autouse=True)
def _fake_group_torn_down():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _cell(tmp_path, arch, shape, mesh_shape, **over):
    return D.run_cell(arch, shape, "single", str(tmp_path), over, smoke=True,
                      mesh_shape=mesh_shape)


def _spec_bytes(cfg, shape, sizes, moment):
    """Rank 0's argument bytes from spec_for: dims divided evenly."""
    def local(meta, spec):
        n = meta.element_size()
        for dim, part in zip(meta.shape, tuple(spec) + (None,) * 8):
            axes = () if part is None else (part if isinstance(part, tuple)
                                            else (part,))
            n *= dim // math.prod(sizes[a] for a in axes)
        return n

    metas, specs = lm.abstract_params(cfg), Sh.param_shardings(cfg, sizes)
    total = sum(local(m, specs[n]) for n, m in metas.items())
    b, bs = input_specs(cfg, shape), Sh.batch_shardings(cfg, shape, sizes)
    total += sum(local(m, bs[n]) for n, m in b.items())
    st = adamw.abstract_state(metas, moment)
    ss = adamw.state_shardings(specs, sizes, moment)
    total += st.step.element_size()
    for f in ("m", "m_scale", "v", "v_scale"):
        total += sum(local(m, getattr(ss, f)[n])
                     for n, m in getattr(st, f).items())
    return total


def test_record_keys_and_argument_bytes(tmp_path):
    """An MoE train cell on a (4, 2) mesh: the reference's keys (and the
    collective counts per kind); argument bytes equal the local shards
    of the specs."""
    rec = _cell(tmp_path, "qwen3_moe_235b_a22b", TRAIN, (4, 2))
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert TOP <= set(rec)
    assert PER_DEVICE <= set(rec["per_device"])
    assert ROOFLINE <= set(rec["roofline"])
    coll = rec["per_device"]["collective"]
    assert {"result_bytes", "wire_bytes", "counts"} <= set(coll)
    assert set(coll["counts"]) == set(D.COLLECTIVES)
    assert coll["wire_bytes"]["total"] > 0
    cfg = get_smoke("qwen3_moe_235b_a22b")
    want = _spec_bytes(cfg, TRAIN, {"data": 4, "model": 2},
                       rec["moment_dtype"])
    assert rec["per_device"]["argument_bytes"] == want
    assert (tmp_path / "qwen3_moe_235b_a22b__t32__single.json").exists()


def test_flops_per_device_split_over_data(tmp_path):
    """A dense train step on a (4, 1) data mesh does a quarter of the (1,
    1) mesh's FLOPs per device; one rank issues no collective."""
    one = _cell(tmp_path, "yi_34b", TRAIN, (1, 1))
    four = _cell(tmp_path, "yi_34b", TRAIN, (4, 1))
    f1, f4 = one["per_device"]["flops"], four["per_device"]["flops"]
    assert f1 > 0 and f4 * 4 == f1
    assert one["per_device"]["collective"]["wire_bytes"]["total"] == 0
    assert sum(one["per_device"]["collective"]["counts"].values()) == 0
    assert four["per_device"]["collective"]["wire_bytes"]["total"] > 0


def test_probes_equal_full_unroll():
    """The L1/L2 (and microbatch 2/3) probe extrapolation equals running
    every layer and microbatch, at 5 layers and 4 microbatches: flops,
    bytes and collectives exactly."""
    cfg = dataclasses.replace(get_smoke("yi_34b"), n_layers=5)
    mesh = D.make_mesh("single", (2, 1))
    shape = ShapeConfig("t16", "train", 16, 8)
    plan = Sh.make_plan(cfg, shape, mesh, ParallelConfig(microbatch=4))
    assert plan.microbatch == 4
    probed, method = D.unrolled_costs(cfg, shape, mesh, plan)
    full, full_method = D.unrolled_costs(cfg, shape, mesh, plan,
                                         full_unroll=True)
    assert method == "probe_extrapolated_L2_L4_mb2_mb3"
    assert full_method == "full_unroll"
    for k in ("flops", "bytes"):
        assert probed[k] == full[k], k
    for k in ("coll_wire", "coll_res", "counts"):
        assert probed[k] == pytest.approx(full[k], rel=0, abs=0), k


def test_decode_cell_on_a_pod_mesh(tmp_path):
    """A hybrid decode cell on a (2, 2, 2) ("pod", "data", "model") mesh
    runs (a sharded cache, one sequence), with argument bytes from the
    local shards."""
    shape = ShapeConfig("d64", "decode", 64, 1)
    rec = _cell(tmp_path, "zamba2_2p7b", shape, (2, 2, 2))
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["per_device"]["flops"] > 0
    assert rec["per_device"]["peak_bytes"] >= \
        rec["per_device"]["argument_bytes"] > 0
