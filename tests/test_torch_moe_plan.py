"""The moe_plan kernel's algorithm — the whole routing plan of
``models/moe.py::route`` in one launch — held against the JAX package's
route pieces: ``jnp.argsort(stable=True)``, the positions from
``moe_route_call`` (Pallas, interpret mode on the CPU) and from
``arbitrate_positions``, then admission, slot and source token.

``plan_ref`` transcribes ``moe_plan_kernel`` (``src/repro_torch/kernels/
moe_route/csrc/moe_route.cu``) in numpy: the tile chosen by N, the packed
key (expert << 14 | position) with pads on expert E - 1 and ids clamped
into [0, E), the stable LSD radix sort in 4-bit digits over the expert's
bit_length(E - 1) bits only, each expert's offset as its run head's
sorted index (checked against the exclusive scan of the expert
histogram), and pos, admit, slot and tok.  The CUDA kernel itself runs
only on the card, where ``chip_smoke.py`` holds it against the plain
version; here the transcription and the port's CPU ``ops.route_plan``
must equal JAX exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.moe_route.ops import \
    route_positions as j_route_positions  # noqa: E402
from repro.models.moe import arbitrate_positions as j_arbitrate  # noqa: E402
from repro_torch.kernels.moe_route import moe_route as mr  # noqa: E402
from repro_torch.kernels.moe_route.ops import route_plan  # noqa: E402
from repro_torch.kernels.moe_route.ref import route_plan_ref  # noqa: E402

TILES = ((128, 2), (256, 4), (512, 8), (1024, 16))   # threads x items
POS_BITS = 14


def plan_ref(flat_ids, E, C, top_k):
    """numpy transcription of moe_plan_kernel.  flat_ids: [N] int32,
    1 <= N <= PLAN_MAX_N.  Returns (order, slot, admit, tok) [N]."""
    ids = np.asarray(flat_ids, np.int32)
    n = len(ids)
    assert 1 <= n <= mr.PLAN_MAX_N and 1 <= E <= mr.PLAN_MAX_E
    T, ipt = next((t, i) for t, i in TILES if t * i >= n)
    tile = T * ipt
    # 1. keys: (expert << 14) | position; pads and stray ids on E - 1
    p = np.arange(tile, dtype=np.uint32)
    e = np.full(tile, E - 1, np.uint32)
    e[:n] = np.minimum(ids.astype(np.uint32), E - 1)
    key = (e << POS_BITS) | p
    # 2. stable LSD radix sort, 4-bit digits, over bits 14 .. 14 + bits
    end_bit = POS_BITS + (E - 1).bit_length()
    for bit in range(POS_BITS, end_bit, 4):
        digit = (key >> bit) & ((1 << min(4, end_bit - bit)) - 1)
        key = key[np.argsort(digit, kind="stable")]
    se, sp = (key >> POS_BITS)[:n], (key & ((1 << POS_BITS) - 1))[:n]
    # 3. offsets: each run head's sorted index
    j = np.arange(n)
    head = np.r_[True, se[1:] != se[:-1]]
    first = np.zeros(E, np.int64)
    first[se[head]] = j[head]
    hist = np.bincount(e[:n], minlength=E)
    np.testing.assert_array_equal(first[se], (np.cumsum(hist) - hist)[se])
    # 4. the plan
    pos = j - first[se]
    admit = pos < C
    slot = np.where(admit, se.astype(np.int64) * C + pos, E * C)
    return (sp.astype(np.int32), slot.astype(np.int32), admit,
            (sp // top_k).astype(np.int32))


def _jax_plan(flat_ids, E, C, top_k):
    """route's plan from the JAX package's pieces (both position
    functions must agree)."""
    ids = jnp.asarray(flat_ids, jnp.int32)
    order = jnp.argsort(ids, stable=True).astype(jnp.int32)
    sorted_ids = ids[order]
    pos = j_route_positions(sorted_ids)
    np.testing.assert_array_equal(np.asarray(pos),
                                  np.asarray(j_arbitrate(sorted_ids)))
    admit = pos < C
    slot = jnp.where(admit, sorted_ids * C + pos, E * C)
    return tuple(np.asarray(x) for x in (order, slot, admit,
                                         order // top_k))


def _ids(n, E, seed, hot=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, E, n)
    if hot:                                   # 90% on one expert
        ids = np.where(rng.random(n) < 0.9, E // 2, ids)
    return ids.astype(np.int32)


def _check(ids, E, top_k, caps):
    """At each capacity: JAX, the transcription, the CPU route_plan and
    the oracle, all exactly equal (dtypes included)."""
    for C in caps:
        want = _jax_plan(ids, E, C, top_k)
        got_ref = plan_ref(ids, E, C, top_k)
        got = route_plan(torch.tensor(ids), E, C, top_k)
        oracle = route_plan_ref(torch.tensor(ids), E, C, top_k)
        assert [g.dtype for g in got] == [torch.int32, torch.int32,
                                          torch.bool, torch.int32]
        for name, w, r, g, o in zip(("order", "slot", "admit", "tok"), want,
                                    got_ref, got, oracle):
            np.testing.assert_array_equal(w, r, err_msg=f"{name} (ref)")
            np.testing.assert_array_equal(w, g.numpy(), err_msg=name)
            np.testing.assert_array_equal(w, o.numpy(), err_msg=name)


@pytest.mark.parametrize("E", [1, 4, 7, 128])
@pytest.mark.parametrize("n", [1, 64, 1000, 16384])
def test_plan_matches_jax(n, E):
    """N from one id to prefill's 16,384, E from one expert (no sort) to
    Qwen3-MoE's 128, at capacity 8 (drops) and N (none dropped)."""
    _check(_ids(n, E, n + E), E, 8, (8, n))


@pytest.mark.parametrize("n", [64, 16384])
def test_plan_hot_expert_matches_jax(n):
    """90% of the ids on one expert: one long run, most of it dropped at
    C = 8; at C = N nothing is."""
    ids = _ids(n, 128, 3, hot=True)
    _check(ids, 128, 8, (8, n))
    assert (~plan_ref(ids, 128, 8, 8)[2]).sum() > n // 2


@pytest.mark.parametrize("n", [256, 257, 1024, 1025, 4096, 4097])
def test_plan_tile_boundaries(n):
    """Every tile boundary of the single-CTA kernel, top_k 2."""
    _check(_ids(n, 128, n), 128, 2, (8,))


def test_stray_ids_stay_in_bounds():
    """Ids outside [0, E) give an unspecified plan in the kernel, but the
    transcription of its clamp never leaves [0, E) for an offset and
    gives every entry a slot in [0, E * C]."""
    ids = np.array([3, -1, 9, 2**31 - 1, 0, 3, -2**31], np.int32)
    order, slot, admit, tok = plan_ref(ids, 4, 2, 1)
    assert sorted(order.tolist()) == list(range(len(ids)))
    assert ((slot >= 0) & (slot <= 4 * 2)).all()


@pytest.mark.parametrize("n,E,chain", [
    (mr.PLAN_MAX_N, 128, False),
    (mr.PLAN_MAX_N + 1, 128, True),             # past PLAN_MAX_N
    (300, mr.PLAN_MAX_E, False),
    (300, mr.PLAN_MAX_E + 1, True),             # past PLAN_MAX_E
])
def test_route_plan_routes_by_size(n, E, chain, monkeypatch):
    """The wrapper takes the argsort + moe_route_call path exactly past
    PLAN_MAX_N or PLAN_MAX_E (spied on ``_plan_from_sort``'s position
    function; a CPU tensor otherwise takes the plain version), equal to
    JAX either way, and a CPU tensor launches nothing."""
    before = dict(mr.LAUNCHES)
    calls = []
    sort_path = mr._plan_from_sort
    monkeypatch.setattr(mr, "_plan_from_sort",
                        lambda *a: calls.append(a[-1]) or sort_path(*a))
    ids = _ids(n, E, 9)
    got = route_plan(torch.tensor(ids), E, 8, 8)
    assert calls == [mr.moe_route_call if chain else mr.moe_route_plain]
    for w, g in zip(_jax_plan(ids, E, 8, 8), got):
        np.testing.assert_array_equal(w, g.numpy())
    if not chain:
        for w, g in zip(plan_ref(ids, E, 8, 8), got):
            np.testing.assert_array_equal(w, g.numpy())
    assert mr.LAUNCHES == before


@pytest.mark.parametrize("bad,err", [
    (lambda x: x.to(torch.int64), TypeError),
    (lambda x: x.reshape(2, 2, 2), ValueError),    # [S, n] is a batch
    (lambda x: torch.stack([x, x], 1)[:, 0], ValueError),   # strided
    (lambda x: torch.stack([x, x], 1).T, ValueError),       # strided [S, n]
    (lambda x: x.numpy(), TypeError),
])
def test_route_plan_call_rejects_bad_inputs(bad, err):
    with pytest.raises(err):
        mr.route_plan_call(bad(torch.arange(8, dtype=torch.int32)), 8, 4, 2)


@pytest.mark.parametrize("E,C,k", [(0, 4, 2), (8, -1, 2), (8, 4, 0),
                                   (2**16, 2**16, 1)])
def test_route_plan_call_rejects_bad_sizes(E, C, k):
    with pytest.raises(ValueError):
        mr.route_plan_call(torch.arange(8, dtype=torch.int32), E, C, k)
