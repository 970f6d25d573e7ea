"""Per-shard MoE arbitration (``moe_ffn_sharded``), token motion and the
batched routing plan against the JAX package, on
``get_smoke("qwen3_moe_235b_a22b")`` in float32 at capacity factor 1.0,
so that entries drop (and shards drop differently from global
arbitration).

Parameters are carried over with ``convert_params``; inputs are made with
numpy.  The reference runs outside any mesh, where its sharding
constraints are no-ops, as the port's are on plain tensors.  Tolerances:
the MoE output at 1e-5 (the same float32 arithmetic; a token's k rows
are summed in another order); integer plan fields exactly, gates and
probabilities at 1e-6; losses at rtol 1e-5 and gradients at rtol 1e-4 /
atol 1e-6, as in ``tests/test_torch_train.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.common.types import ParallelConfig as JParallel  # noqa: E402
from repro.configs.registry import get_smoke as j_get_smoke  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro_torch.common.types import ParallelConfig  # noqa: E402
from repro_torch.configs.registry import get_smoke  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.kernels.moe_route import moe_route as mr  # noqa: E402
from repro_torch.launch.steps import grads_of  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

ARCH = "qwen3_moe_235b_a22b"
B, L = 4, 16
INT_FIELDS = ("order", "slot", "admit", "tok", "ids")


def _cfgs():
    """Float32 (JAX cfg, port cfg) at capacity factor 1.0."""
    return tuple(dataclasses.replace(
        c, dtype="float32",
        moe=dataclasses.replace(c.moe, capacity_factor=1.0))
        for c in (j_get_smoke(ARCH), get_smoke(ARCH)))


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = _cfgs()
    jparams = JLM.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {n: np.asarray(a) for n, a in JP.flatten(jparams).items()}
    return jcfg, tcfg, jparams, convert_params(flat, tcfg, "cpu")


def _eparams(layer, j):
    names = dict(router="router", w_gate="e_gate", w_up="e_up",
                 w_down="e_down")
    if j:
        return {k: layer[v] for k, v in names.items()}
    return {k: layer[f"layers/{v}"][0] for k, v in names.items()}


def _skewed(rng, T, jparams):
    """[T, d] inputs leaning toward expert 0's router column, so that
    expert 0 is hot and entries drop."""
    w0 = np.asarray(jparams["layers"]["router"][0][:, 0], np.float32)
    x = rng.standard_normal((T, w0.shape[0])).astype(np.float32)
    return x + 2.0 * w0 / np.linalg.norm(w0) ** 2


def _plans_equal(jplan, tplan):
    assert set(jplan) == set(tplan)
    for k in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(jplan[k]),
                                      tplan[k].numpy(), err_msg=k)
    for k in ("gate", "probs"):
        np.testing.assert_allclose(np.asarray(jplan[k]), tplan[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("shards", [2, 4])
def test_moe_ffn_sharded_matches_jax(world, shards):
    """y within 1e-5 and every plan field equal; per-shard capacity drops
    entries, and differently from global arbitration."""
    jcfg, tcfg, jparams, tp = world
    T = B * L
    x = _skewed(np.random.default_rng(shards), T, jparams)
    cap = TM.capacity_for(T, tcfg.moe)
    assert cap == JM.capacity_for(T, jcfg.moe)
    jl = {n: a[0] for n, a in jparams["layers"].items()}
    jy, jplan = JM.moe_ffn_sharded(jnp.asarray(x), _eparams(jl, True),
                                   jcfg.moe, jax.nn.silu, cap, shards)
    ty, tplan = TM.moe_ffn_sharded(torch.tensor(x), _eparams(tp, False),
                                   tcfg.moe, torch.nn.functional.silu, cap,
                                   shards)
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=1e-5,
                               atol=1e-5)
    _plans_equal(jplan, tplan)
    assert tplan["order"].shape == (T * tcfg.moe.top_k,)
    n = T * tcfg.moe.top_k // shards            # ids per shard
    assert int(tplan["order"].max()) < n        # relative to the shard
    _, gplan = TM.moe_ffn(torch.tensor(x), _eparams(tp, False), tcfg.moe,
                          torch.nn.functional.silu, cap)
    assert int((~tplan["admit"]).sum()) > 0
    assert int((~tplan["admit"]).sum()) != int((~gplan["admit"]).sum())


def test_moe_ffn_token_motion_matches_jax(world):
    """token_motion only constrains layouts: y and the plan equal JAX's
    with and without it."""
    jcfg, tcfg, jparams, tp = world
    T = B * L
    x = _skewed(np.random.default_rng(5), T, jparams)
    cap = TM.capacity_for(T, tcfg.moe)
    jl = {n: a[0] for n, a in jparams["layers"].items()}
    jy, jplan = JM.moe_ffn(jnp.asarray(x), _eparams(jl, True), jcfg.moe,
                           jax.nn.silu, cap, token_motion=True)
    ty, tplan = TM.moe_ffn(torch.tensor(x), _eparams(tp, False), tcfg.moe,
                           torch.nn.functional.silu, cap, token_motion=True)
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=1e-5,
                               atol=1e-5)
    _plans_equal(jplan, tplan)


@pytest.mark.parametrize("shards,n,E", [(2, 512, 128), (4, 256, 8),
                                        (3, 100, 384)])
def test_batched_plain_plan_equals_single_plans(shards, n, E):
    """A batch of plans [S, n] (the kernel's batched form) equals S
    single plans, each relative to its own row, and the batched route
    equals S routes."""
    rng = np.random.default_rng(n)
    ids = torch.tensor(rng.integers(0, E, (shards, n)).astype(np.int32))
    cap = max(8, n // E)
    got = mr.route_plan_call(ids, E, cap, 8)
    want = [mr.route_plan_call(ids[s].contiguous(), E, cap, 8)
            for s in range(shards)]
    for f, g in enumerate(got):
        assert g.shape == (shards, n)
        for s in range(shards):
            assert torch.equal(g[s], want[s][f]), (f, s)
    x = torch.tensor(rng.standard_normal((shards, 32, 16)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((16, 8)).astype(np.float32))
    moe = get_smoke(ARCH).moe
    batched = TM.route(x, w, moe, 8)
    for s in range(shards):
        one = TM.route(x[s], w, moe, 8)
        for k, v in one.items():
            assert torch.equal(batched[k][s], v), (k, s)


def _batch(seed, vocab):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (B, L)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("kw", [dict(moe_arbitration_shards=2),
                                dict(moe_token_motion=True)],
                         ids=["shards2", "token_motion"])
def test_forward_loss_and_grads_match_jax(world, kw):
    """forward's logits at 1e-5, ``loss_fn`` (total, loss, zloss,
    moe_aux) at rtol 1e-5 and every gradient at rtol 1e-4 / atol 1e-6,
    under the option, against the JAX package's."""
    jcfg, tcfg, jparams, tp = world
    b = _batch(11, tcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jpar, tpar = JParallel(remat="none", **kw), ParallelConfig(remat="none",
                                                               **kw)
    jlog, _, _ = JLM.forward(jcfg, jparams, jb, jpar)
    tlog, _, _ = TLM.forward(tcfg, tp, b, tpar)
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), rtol=1e-5,
                               atol=1e-5)
    jt, jm = JLM.loss_fn(jcfg, jparams, jb, jpar)
    tt, tm = TLM.loss_fn(tcfg, tp, b, tpar)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    for k in ("loss", "zloss", "moe_aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    jg = JP.flatten(jax.grad(lambda p: JLM.loss_fn(jcfg, p, jb, jpar)[0])(
        jparams))
    _, tg = grads_of(tcfg, tpar, tp, b)
    assert set(tg) == set(jg)
    for n, g in jg.items():
        np.testing.assert_allclose(tg[n].numpy(), np.asarray(g, np.float32),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
