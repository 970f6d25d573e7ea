"""The port's training path against the JAX package's, on
``get_smoke("qwen3_moe_235b_a22b")`` in float32: ``loss_fn`` and its
gradients, and ``make_train_step`` for every moment dtype, with and
without gradient accumulation and rematerialization.

The JAX package's parameters (and, step by step, its optimizer state) are
carried over with ``convert_params`` / ``convert_opt_state``; batches are
made with numpy and handed to both.  The reference runs outside any mesh,
where its sharding constraints are no-ops.  Tolerances: losses at 1e-5
and gradients at rtol 1e-4 / atol 1e-6 (the same float32 arithmetic,
summed in another order); parameters after a step at rtol 1e-5, with the
elements beyond it counted and explained (see ``_check_params``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.common.types import ParallelConfig as JParallel  # noqa: E402
from repro.common.types import TrainConfig as JTrain  # noqa: E402
from repro.configs.registry import get_smoke as j_get_smoke  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.common.types import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs.registry import get_smoke  # noqa: E402
from repro_torch.convert import convert_opt_state, convert_params  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.steps import grads_of, make_train_step  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402

ARCH = "qwen3_moe_235b_a22b"
B, L = 4, 16
MOMENTS = ("float32", "bfloat16", "int8")


def _cfgs(capacity_factor=None):
    """Float32 (JAX cfg, port cfg); a capacity factor below the smoke
    config's 8.0 makes the routing drop entries."""
    out = []
    for c in (j_get_smoke(ARCH), get_smoke(ARCH)):
        c = dataclasses.replace(c, dtype="float32")
        if capacity_factor is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=capacity_factor))
        out.append(c)
    return out


def _np(a):
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs()
    return JLM.init_params(jcfg, jax.random.PRNGKey(0))


def _flat(tree):
    return {n: np.asarray(a) for n, a in JP.flatten(tree).items()}


def _batch(seed, vocab, masked=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, L)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, L)).astype(np.int32)
    if masked:
        labels[0, :5] = -1
        labels[2, -3:] = -1
    return {"tokens": toks, "labels": labels}


# --------------------------------------------------------------- loss_fn --

@pytest.mark.parametrize("capacity_factor,masked", [
    (None, False), (None, True), (1.0, False)])
def test_loss_fn_matches_jax(jparams, capacity_factor, masked):
    """total, loss, zloss and moe_aux at rtol 1e-5, with masked labels
    and with a capacity that drops entries."""
    jcfg, tcfg = _cfgs(capacity_factor)
    b = _batch(1, tcfg.vocab_size, masked)
    jt, jm = JLM.loss_fn(jcfg, jparams, {k: jnp.asarray(v)
                                         for k, v in b.items()})
    tp = convert_params(_flat(jparams), tcfg, "cpu")
    tt, tm = TLM.loss_fn(tcfg, tp, {k: torch.tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    for k in ("loss", "zloss", "moe_aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    assert tt.dtype == torch.float32


@pytest.mark.parametrize("capacity_factor", [None, 1.0])
def test_gradients_match_jax(jparams, capacity_factor):
    """Every leaf's gradient against ``jax.grad`` at rtol 1e-4 / atol
    1e-6; dropped entries get no gradient through the dispatch in both."""
    jcfg, tcfg = _cfgs(capacity_factor)
    b = _batch(2, tcfg.vocab_size, masked=True)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jg = JP.flatten(jax.grad(lambda p: JLM.loss_fn(jcfg, p, jb)[0])(jparams))
    tp = convert_params(_flat(jparams), tcfg, "cpu")
    before = {n: t.clone() for n, t in tp.items()}
    _, tg = grads_of(tcfg, None, tp, b)
    assert set(tg) == set(jg)
    for n, g in jg.items():
        assert tg[n].dtype == tp[n].dtype and not tp[n].requires_grad, n
        np.testing.assert_allclose(tg[n].numpy(), _np(g), rtol=1e-4,
                                   atol=1e-6, err_msg=n)
    assert all(torch.equal(before[n], tp[n]) for n in tp)


def test_dict_forward_equals_lm_module(jparams):
    """The training forward on the flat dict and the serving ``LM``
    compute the same logits, cache and aux bit for bit."""
    _, tcfg = _cfgs()
    tp = convert_params(_flat(jparams), tcfg, "cpu")
    toks = torch.tensor(_batch(3, tcfg.vocab_size)["tokens"])
    a = TLM.forward(tcfg, tp, {"tokens": toks}, collect_cache=True)
    b = TLM.forward(tcfg, TLM.LM(tcfg, tp), {"tokens": toks},
                    collect_cache=True)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][n], b[1][n]) for n in ("k", "v"))
    assert torch.equal(a[2]["moe_aux"], b[2]["moe_aux"])


# ------------------------------------------------------- make_train_step --

def _check_params(jp, tp, jo_in, lr, md):
    """Parameters after one step at rtol 1e-5.  Elements beyond it are
    counted (at most 0.5% of all) and each must be explained:

    - Adam's update of a near-zero gradient is about +-1 whatever its
      size, so an element whose gradient sign differs by rounding moves
      by at most 2 lr_t more than its twin;
    - with int8 moments, a second moment that was stored as 0 (its row's
      scale makes it round to 0) leaves only the step's own g^2 under a
      non-zero first moment, and the update grows as 1/|g|, multiplying
      the gradient's rounding without bound; such elements (at most
      1e-4 of all) are checked to have that zero second moment."""
    beyond = amplified = total = 0
    for n, j in _flat(jp).items():
        j, t = _np(j), tp[n].float().numpy()
        err = np.abs(t - j)
        bad = err > 1e-5 * np.abs(j)
        big = err > 2 * lr + 1e-5 * np.abs(j)
        if big.any():
            assert md == "int8", (n, float(err.max()), 2 * lr)
            v0 = np.asarray(JP.flatten(jo_in.v)[n]) == 0
            m0 = np.asarray(JP.flatten(jo_in.m)[n]) == 0
            assert (v0 & ~m0)[big].all(), n
        beyond += int(bad.sum())
        amplified += int(big.sum())
        total += j.size
    assert beyond <= 0.005 * total, (beyond, total)
    assert amplified <= 1e-4 * total, (amplified, total)


def _check_state(jo, to, md, mb):
    """Moments after one step.  float32: rtol 1e-4 / atol 1e-4 of the
    leaf's largest value (the gradients' rounding, relative to the
    moment's scale); bfloat16: within one bf16 ulp of the value (2^-7)
    plus that atol; int8: payloads within one count, scales at rtol 1e-4.
    With mb = 2 the microbatch gradients are summed in bf16 (the MoE
    family's accumulation dtype), so a sum may differ by a bf16 ulp of
    its addends: the atol becomes 2^-8 of the leaf's largest value and
    the int8 scales' rtol 2^-7."""
    assert int(to.step) == int(jo.step)
    for f in ("m", "v"):
        for n, j in _flat(getattr(jo, f)).items():
            t = getattr(to, f)[n]
            if md == "int8":
                assert t.dtype == torch.int8
                d = np.abs(t.numpy().astype(np.int32) - j.astype(np.int32))
                assert d.max() <= 1, (f, n)
                sj = _flat(getattr(jo, f + "_scale"))[n]
                ts = getattr(to, f + "_scale")[n].numpy()
                np.testing.assert_allclose(ts, sj, rtol=1e-4 if mb == 1
                                           else 2 ** -7, err_msg=n)
            else:
                j, t = _np(j), t.float().numpy()
                atol = (1e-4 if mb == 1 else 2 ** -8) * float(
                    np.abs(j).max())
                rtol = 1e-4 if md == "float32" else 2 ** -7
                np.testing.assert_allclose(t, j, rtol=rtol, atol=atol,
                                           err_msg=f"{f} {n}")


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("md", MOMENTS)
def test_train_step_matches_jax(jparams, md, mb):
    """3 steps of ``make_train_step``.  Each step starts the port from
    the JAX package's parameters and optimizer state (converted), so that
    each step is compared on its own: int8 moments would otherwise carry
    one count of rounding into an amplified update (``_check_params``).
    Loss, grad norm and lr at rtol 1e-5."""
    jcfg, tcfg = _cfgs()
    tc, jtc = TrainConfig(warmup_steps=2), JTrain(warmup_steps=2)
    par = dict(remat="none", microbatch=mb, moment_dtype=md)
    jstep = jax.jit(j_train_step(jcfg, JParallel(**par), jtc))
    tstep = make_train_step(tcfg, ParallelConfig(**par), tc)
    data = SyntheticLM(tcfg, L, B)
    jp, jo = jparams, JA.init_state(jparams, md)
    for s in range(3):
        batch = data.batch(s)
        tp = convert_params(_flat(jp), tcfg, "cpu")
        to = convert_opt_state(jax.tree.map(np.asarray, jo), "cpu")
        jo_in = jo
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp2, to, tm = tstep(tp, to, batch)
        assert tp2 is tp
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
        _check_params(jp, tp, jo_in, float(jm["lr"]), md)
        _check_state(jo, to, md, mb)


def test_train_step_remat_full_equals_none(jparams):
    """remat="full" (each layer recomputed in the backward) gives the
    same parameters and moments as "none", bit for bit, over 3 steps."""
    _, tcfg = _cfgs()
    data = SyntheticLM(tcfg, L, B)
    out = {}
    for remat in ("none", "full"):
        tp = convert_params(_flat(jparams), tcfg, "cpu")
        to = TA.init_state(tp, "float32")
        step = make_train_step(tcfg, ParallelConfig(
            remat=remat, microbatch=1, moment_dtype="float32"),
            TrainConfig(warmup_steps=2))
        for s in range(3):
            tp, to, m = step(tp, to, data.batch(s))
        out[remat] = (tp, to, float(m["loss"]))
    (a, ao, al), (b, bo, bl) = out["none"], out["full"]
    assert al == bl
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert all(torch.equal(ao.m[n], bo.m[n]) and torch.equal(ao.v[n], bo.v[n])
               for n in a)


def test_train_step_keeps_an_lm_current(jparams):
    """The update is in place: an ``LM`` built over the parameter dict
    before a step serves the stepped parameters."""
    _, tcfg = _cfgs()
    tp = convert_params(_flat(jparams), tcfg, "cpu")
    model = TLM.LM(tcfg, tp)
    toks = torch.tensor(_batch(4, tcfg.vocab_size)["tokens"])
    before = TLM.forward(tcfg, model, {"tokens": toks})[0]
    step = make_train_step(tcfg, ParallelConfig(remat="none", microbatch=1,
                                                moment_dtype="float32"),
                           TrainConfig(warmup_steps=1))
    step(tp, TA.init_state(tp, "float32"), SyntheticLM(tcfg, L, B).batch(0))
    after = TLM.forward(tcfg, model, {"tokens": toks})[0]
    assert not torch.equal(before, after)
    assert torch.equal(after, TLM.forward(tcfg, tp, {"tokens": toks})[0])


def test_convert_opt_state_round_trip(jparams):
    """The reference's AdamWState as numpy -> the port's: names, shapes,
    dtypes and values (bf16 bit for bit, int8 as it is)."""
    jo = JA.init_state(jparams, "int8")
    jo = jo._replace(
        step=jnp.asarray(7, jnp.int32),
        m=jax.tree.map(lambda a: jnp.ones_like(a) * 3, jo.m),
        v_scale=jax.tree.map(lambda a: a + 0.5, jo.v_scale))
    to = convert_opt_state(jax.tree.map(np.asarray, jo), "cpu")
    assert int(to.step) == 7 and to.step.dtype == torch.int32
    for f in ("m", "m_scale", "v", "v_scale"):
        jf = _flat(getattr(jo, f))
        assert set(getattr(to, f)) == set(jf)
        for n, a in jf.items():
            t = getattr(to, f)[n]
            assert str(t.dtype) == f"torch.{a.dtype}", (f, n)
            np.testing.assert_array_equal(t.numpy(), a)
    jb = JA.init_state(jparams, "bfloat16")
    jb = jb._replace(m=jax.tree.map(lambda a: a + 1.5, jb.m))
    tb = convert_opt_state(jax.tree.map(np.asarray, jb), "cpu")
    assert tb.m["embed"].dtype == torch.bfloat16
    assert bool((tb.m["embed"] == 1.5).all())
    with pytest.raises(KeyError):
        bad = jax.tree.map(np.asarray, jo)
        convert_opt_state(bad._replace(v={"embed": bad.v["embed"]}), "cpu")
    assert TP.flatten(TP.unflatten(to.m)).keys() == to.m.keys()
