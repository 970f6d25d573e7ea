"""The port's moe_route op against the JAX package's Pallas kernel
(interpret mode on the CPU) and oracle, and against the port's own switch
engine's counter semantics.

On the CPU the launcher runs its plain PyTorch version; the CUDA kernel
itself is held against that plain version on the card by
``chip_smoke.py``.  Positions are int32 with one right answer, so every
comparison is exact."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.moe_route.ops import \
    route_positions as j_route_positions  # noqa: E402
from repro.kernels.moe_route.ref import \
    positions_ref as j_positions_ref  # noqa: E402
from repro_torch.core.engine import SwitchEngine  # noqa: E402
from repro_torch.core.packets import (ADD, SwitchConfig,  # noqa: E402
                                      empty_packets)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.moe_route import moe_route as mr  # noqa: E402
from repro_torch.kernels.moe_route.ops import route_positions  # noqa: E402
from repro_torch.kernels.moe_route.ref import positions_ref  # noqa: E402
from repro_torch.models.moe import arbitrate_positions  # noqa: E402


def _sorted_ids(n, n_experts, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, n_experts, n)).astype(np.int32)


def _port_all(ids):
    """The launcher, the op, the oracle and the MoE layer's arbitration on
    one CPU stream; all four must agree.  Returns the positions."""
    t = torch.tensor(ids, dtype=torch.int32)
    outs = [mr.moe_route_call(t), route_positions(t), positions_ref(t),
            arbitrate_positions(t)]
    for o in outs:
        assert o.dtype == torch.int32 and o.shape == t.shape
        np.testing.assert_array_equal(o.numpy(), outs[0].numpy())
    return outs[0].numpy()


@pytest.mark.parametrize("n,n_experts,block", [
    (64, 4, 16),
    (1000, 7, 128),        # the reference pads; the port needs no padding
    (4096, 128, 512),
    (513, 1, 64),          # single expert, all one segment
])
def test_moe_route_matches_jax(n, n_experts, block):
    """tests/test_kernels.py::test_moe_route_kernel's streams: the port
    equals the Pallas kernel (interpret mode) and the JAX oracle."""
    ids = _sorted_ids(n, n_experts, n)
    want = np.asarray(j_positions_ref(jnp.asarray(ids)))
    np.testing.assert_array_equal(
        np.asarray(j_route_positions(jnp.asarray(ids), block=block)), want)
    np.testing.assert_array_equal(_port_all(ids), want)


def test_moe_route_matches_switch_counter_semantics():
    """Positions == the pre-increment counter each token reads when tokens
    (packets) increment their expert's register in admission order, on
    the port's own switch engine."""
    E, N = 8, 64
    ids = _sorted_ids(N, E, 0)
    cfg = SwitchConfig(n_stages=1, regs_per_stage=E, max_instrs=1)
    eng = SwitchEngine(cfg, device="cpu")
    p = empty_packets(N, cfg)
    p["op"][:, 0] = ADD
    p["reg"][:, 0] = ids
    p["operand"][:, 0] = 1
    res, _, _ = eng.execute(p)                  # post-increment values
    np.testing.assert_array_equal(_port_all(ids), res[:, 0] - 1)


@pytest.mark.parametrize("case", ["one", "hot_expert", "runs_cross_1024",
                                  "extreme_ids"])
def test_moe_route_edge_streams(case):
    """The streams chip_smoke.py also runs on the card, against a serial
    counter walk."""
    rng = np.random.default_rng(3)
    if case == "one":
        ids = np.array([5], np.int32)
    elif case == "hot_expert":                  # 90% of entries on one id
        ids = np.sort(np.where(rng.random(4096) < 0.9, 17,
                               rng.integers(0, 128, 4096))).astype(np.int32)
    elif case == "runs_cross_1024":             # a run straddles each 1024
        ids = np.repeat(np.arange(9, dtype=np.int32), 1000)[:8192]
    else:
        ids = np.array([-2**31, -2**31, -1, 0, 0, 2**31 - 1, 2**31 - 1],
                       np.int32)
    want = np.zeros(len(ids), np.int32)
    for i in range(1, len(ids)):
        want[i] = want[i - 1] + 1 if ids[i] == ids[i - 1] else 0
    np.testing.assert_array_equal(_port_all(ids), want)


def test_moe_route_empty_and_cpu_streams_launch_nothing():
    before = dict(mr.LAUNCHES)
    out = mr.moe_route_call(torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0,) and out.dtype == torch.int32
    _port_all(_sorted_ids(300, 5, 1))
    assert mr.LAUNCHES == before


@pytest.mark.parametrize("bad,err", [
    (lambda x: x.to(torch.int64), TypeError),
    (lambda x: x.reshape(2, 4), ValueError),
    (lambda x: torch.stack([x, x], 1)[:, 0], ValueError),   # strided
    (lambda x: x.numpy(), TypeError),
])
def test_moe_route_rejects_bad_inputs(bad, err):
    with pytest.raises(err):
        mr.moe_route_call(bad(torch.arange(8, dtype=torch.int32)))


def test_route_positions_casts_and_compacts():
    """The op takes any integer dtype and layout, as the reference's jnp
    wrapper does."""
    ids = torch.tensor([0, 0, 1, 1, 1, 4], dtype=torch.int64)
    assert route_positions(ids).tolist() == [0, 1, 0, 1, 2, 0]
    strided = torch.stack([ids, ids], 1)[:, 0]
    assert route_positions(strided).tolist() == [0, 1, 0, 1, 2, 0]


def test_kernel_build_binds_every_export():
    """Every library of kernels/build.py names an existing source, binds
    exactly the C functions its ``extern "C"`` block defines (the fused
    scan's ``scan_prune_launch`` / ``scan_prune_large_launch`` and the
    routing plan's ``moe_plan_launch`` among them), and each bound
    function has as many ctypes argtypes as its C definition has
    parameters (a miscount would only show on the card)."""
    assert set(build.LIBRARIES) == {"switch_txn", "switch_engine",
                                    "moe_route"}
    bound = set()
    for name, (source, exports) in build.LIBRARIES.items():
        text = source.read_text()
        defined = re.findall(r"^int (\w+)\(",
                             text[text.index('extern "C" {'):], re.M)
        assert sorted(defined) == sorted(exports), name
        bound |= set(exports)
        for fn, argtypes in exports.items():
            m = re.search(r"^int " + fn + r"\(([^)]*)\)", text, re.M)
            assert m, f"{fn} is not defined in {source.name}"
            assert len(m.group(1).split(",")) == len(argtypes), fn
    assert {"scan_prune_launch", "scan_prune_large_launch",
            "scan_prune_scratch_len", "moe_plan_launch",
            "switch_walk_smem_launch", "switch_walk_launch"} <= bound
