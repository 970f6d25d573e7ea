"""The port's AdamW and gradient compression against the JAX package's,
on random trees and tensors made with numpy and handed to both.

Tolerances: quantization, dequantization and hot-row pre-aggregation bit
for bit (the same IEEE float32 operations in the same order); an AdamW
step on identical gradients at rtol 1e-6 for parameters and float32
moments (the same operations; the bias corrections' float32 ``pow`` may
round its last bit differently), bf16 moments within one bf16 ulp, int8
payloads within one count; the port's sliced update against its unsliced
one bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.common.types import TrainConfig as JTrain  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim.compress import dequantize_int8 as j_dequantize  # noqa: E402
from repro.optim.compress import hot_row_preaggregate as j_preagg  # noqa: E402
from repro.optim.compress import quantize_int8 as j_quantize  # noqa: E402
from repro_torch.common.types import TrainConfig  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim.compress import (dequantize_int8,  # noqa: E402
                                        ef_compress_step,
                                        hot_row_preaggregate, quantize_int8)

MOMENTS = ("float32", "bfloat16", "int8")
SHAPES = {"a": (8, 64), "blk/b": (3, 5, 40), "blk/c": (64,), "d": (16, 32)}


def _tree(rng, scale=1.0):
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _nest(flat):
    out = {}
    for n, v in flat.items():
        *path, leaf = n.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _state(rng, md, step):
    """Random moments (v >= 0) at ``step``, as numpy, stored in ``md``
    by the reference's own quantizer."""
    m = _tree(rng, 0.01)
    v = {n: np.abs(a) * 1e-3 for n, a in _tree(rng).items()}
    if md == "int8":
        qm = {n: j_quantize(jnp.asarray(a)) for n, a in m.items()}
        qv = {n: j_quantize(jnp.asarray(a)) for n, a in v.items()}
        pay = lambda q: {n: np.asarray(x[0]) for n, x in q.items()}
        sc = lambda q: {n: np.asarray(x[1]) for n, x in q.items()}
        return step, pay(qm), sc(qm), pay(qv), sc(qv)
    dt = jnp.bfloat16 if md == "bfloat16" else jnp.float32
    one = {n: np.zeros((1,), np.float32) for n in SHAPES}
    cast = lambda t: {n: np.asarray(jnp.asarray(a).astype(dt))
                      for n, a in t.items()}
    return step, cast(m), one, cast(v), one


def _torch_state(st):
    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.view(np.int16)).view(torch.bfloat16)
        return torch.tensor(a)
    step, *trees = st
    return TA.AdamWState(torch.tensor(step, dtype=torch.int32),
                         *({n: t(a) for n, a in tr.items()} for tr in trees))


def _jax_state(st):
    step, *trees = st
    return JA.AdamWState(jnp.asarray(step, jnp.int32),
                         *(_nest({n: jnp.asarray(a) for n, a in tr.items()})
                           for tr in trees))


@pytest.mark.parametrize("md", MOMENTS)
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_apply_updates_matches_jax(md, grad_scale):
    """One step from a mid-training state (step 4 of a 3-step warmup), on
    identical gradients, unclipped (norm < 1) and clipped (norm >> 1);
    leaves of ndim 1 take no weight decay in both."""
    rng = np.random.default_rng(7)
    p, g = _tree(rng), _tree(rng, grad_scale)
    st = _state(rng, md, 4)
    tc = dict(warmup_steps=3, weight_decay=0.1)
    jp, jo, jm = JA.apply_updates(_nest({n: jnp.asarray(a)
                                         for n, a in p.items()}),
                                  _nest({n: jnp.asarray(a)
                                         for n, a in g.items()}),
                                  _jax_state(st), JTrain(**tc), md)
    tp = {n: torch.tensor(a) for n, a in p.items()}
    tp2, to, tm = TA.apply_updates(tp, {n: torch.tensor(a)
                                        for n, a in g.items()},
                                   _torch_state(st), TrainConfig(**tc), md)
    assert tp2 is tp and int(to.step) == 5
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert (float(tm["grad_norm"]) > 1.0) == (grad_scale > 1)
    for n, a in _flat(jp).items():
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    for f in ("m", "v", "m_scale", "v_scale"):
        for n, a in _flat(getattr(jo, f)).items():
            t, a = getattr(to, f)[n], np.asarray(a)
            if md == "int8" and f in ("m", "v"):
                assert t.dtype == torch.int8
                d = np.abs(t.numpy().astype(np.int32) - a.astype(np.int32))
                assert d.max() <= 1, (f, n)
            elif md == "bfloat16" and f in ("m", "v"):
                assert t.dtype == torch.bfloat16
                np.testing.assert_allclose(t.float().numpy(),
                                           a.astype(np.float32),
                                           rtol=2 ** -7, err_msg=n)
            else:
                np.testing.assert_allclose(t.numpy(), a, rtol=1e-6,
                                           err_msg=f"{f} {n}")


@pytest.mark.parametrize("md", MOMENTS)
def test_sliced_update_equals_unsliced(monkeypatch, md):
    """Slicing the update into row blocks (here a row or two per slice)
    changes no bit: parameters, payloads, scales and metrics, clipped."""
    rng = np.random.default_rng(11)
    p, g = _tree(rng), _tree(rng, 10.0)
    st = _state(rng, md, 2)
    outs = []
    for elems in (TA.SLICE_ELEMS, 100):
        monkeypatch.setattr(TA, "SLICE_ELEMS", elems)
        assert len(TA._row_slices(torch.zeros(SHAPES["a"]),
                                  TA.SLICE_ELEMS)) == (1 if elems > 1000
                                                       else 8)
        tp = {n: torch.tensor(a) for n, a in p.items()}
        outs.append(TA.apply_updates(tp, {n: torch.tensor(a) for n, a in
                                          g.items()}, _torch_state(st),
                                     TrainConfig(warmup_steps=1), md))
    (pa, sa, ma), (pb, sb, mb) = outs
    assert all(torch.equal(pa[n], pb[n]) for n in SHAPES)
    for f in ("m", "m_scale", "v", "v_scale"):
        assert all(torch.equal(getattr(sa, f)[n], getattr(sb, f)[n])
                   for n in SHAPES), f
    assert torch.equal(ma["grad_norm"], mb["grad_norm"])


def test_init_state_and_lr_schedule():
    rng = np.random.default_rng(0)
    p = {n: torch.tensor(a).to(torch.bfloat16)
         for n, a in _tree(rng).items()}
    for md in MOMENTS:
        st = TA.init_state(p, md)
        js = JA.init_state({n: jnp.zeros(s, jnp.bfloat16)
                            for n, s in SHAPES.items()}, md)
        assert int(st.step) == 0 and st.step.dtype == torch.int32
        for f in ("m", "m_scale", "v", "v_scale"):
            for n, a in getattr(js, f).items():
                t = getattr(st, f)[n]
                assert tuple(t.shape) == a.shape, (md, f, n)
                assert str(t.dtype) == f"torch.{a.dtype}", (md, f, n)
                assert not bool(t.any())
    tc, jtc = TrainConfig(warmup_steps=4), JTrain(warmup_steps=4)
    for s in range(7):
        assert float(TA.lr_at(tc, torch.tensor(s, dtype=torch.int32))) == \
            float(JA.lr_at(jtc, jnp.asarray(s, jnp.int32)))


# ------------------------------------------------------------ compression --

@pytest.mark.parametrize("seed", range(6))
def test_quantize_dequantize_match_jax(seed):
    """Bit for bit, including rows of zeros and ties at .5."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((8, 64)) * rng.uniform(0.01, 10)).astype(
        np.float32)
    x[3] = 0.0
    x[5, :2] = [127.0, 0.5]               # scale 1: 0.5 rounds to even 0
    q, s = quantize_int8(torch.tensor(x))
    jq, js = j_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(j_dequantize(jq, js)))
    assert int(q[5, 1]) == 0


@pytest.mark.parametrize("seed", range(10))
def test_int8_quantization_bounded_error(seed):
    """The reference's property on the port: error <= scale / 2."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((8, 64)) * rng.uniform(0.01, 10),
                     dtype=torch.float32)
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs()
    assert bool((err <= s / 2 + 1e-9 + 1e-6).all())


def test_error_feedback_reduces_bias():
    """The reference's property on the port (tests/test_runtime.py)."""
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.standard_normal((4, 256)), dtype=torch.float32) \
        * 0.01
    resid = torch.zeros_like(g)
    acc_ef = torch.zeros_like(g)
    acc_naive = torch.zeros_like(g)
    for _ in range(50):
        gq, resid = ef_compress_step(g, resid)
        acc_ef = acc_ef + gq
        acc_naive = acc_naive + dequantize_int8(*quantize_int8(g))
    true = g * 50
    assert float((acc_ef - true).abs().mean()) <= \
        float((acc_naive - true).abs().mean()) + 1e-7


@pytest.mark.parametrize("n_ids", [1, 5, 64])
def test_hot_row_preaggregate_matches_jax(n_ids):
    """Unique ids, sums and count bit for bit (both sum each segment in
    stream order), and the sums equal a dense scatter-add."""
    rng = np.random.default_rng(n_ids)
    ids = rng.integers(0, n_ids, 64).astype(np.int32)
    g = rng.standard_normal((64, 8)).astype(np.float32)
    u, agg, count = hot_row_preaggregate(torch.tensor(ids), torch.tensor(g))
    ju, jagg, jcount = j_preagg(jnp.asarray(ids), jnp.asarray(g))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(agg.numpy(), np.asarray(jagg))
    assert int(count) == int(jcount) == len(np.unique(ids))
    dense = np.zeros((n_ids, 8), np.float32)
    np.add.at(dense, ids, g)
    for i in range(int(count)):
        np.testing.assert_allclose(agg[i].numpy(), dense[int(u[i])],
                                   rtol=1e-5, atol=1e-5)
