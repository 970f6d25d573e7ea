"""remat="dots" (``models/lm.py::_dots_saveable``) against the JAX
package's ``jax.checkpoint`` with ``dots_with_no_batch_dims_saveable``,
on ``get_smoke("qwen3_moe_235b_a22b")`` in float32, and what each remat
mode recomputes in the backward.

Tolerances as in ``tests/test_torch_train.py``: the loss at rtol 1e-5,
gradients at rtol 1e-4 / atol 1e-6 against JAX; against the port's own
remat="none" bit for bit (the recomputation repeats the same float32
arithmetic on the CPU)."""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.common.types import ParallelConfig as JParallel  # noqa: E402
from repro.configs.registry import get_smoke as j_get_smoke  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro_torch.common.types import ParallelConfig  # noqa: E402
from repro_torch.configs.registry import get_smoke  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.launch.steps import grads_of  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402

ARCH = "qwen3_moe_235b_a22b"
B, L = 4, 16


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = (dataclasses.replace(c, dtype="float32")
                  for c in (j_get_smoke(ARCH), get_smoke(ARCH)))
    jparams = JLM.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {n: np.asarray(a) for n, a in JP.flatten(jparams).items()}
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, tcfg.vocab_size, (B, L)).astype(np.int32)
             for k in ("tokens", "labels")}
    return jcfg, tcfg, jparams, flat, batch


def test_remat_dots_matches_jax_and_none(world):
    jcfg, tcfg, jparams, flat, b = world
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jpar = JParallel(remat="dots")
    jt, _ = JLM.loss_fn(jcfg, jparams, jb, jpar)
    jg = JP.flatten(jax.grad(lambda p: JLM.loss_fn(jcfg, p, jb, jpar)[0])(
        jparams))
    tp = convert_params(flat, tcfg, "cpu")
    tt, tg = grads_of(tcfg, ParallelConfig(remat="dots"), tp, b)
    nt, ng = grads_of(tcfg, ParallelConfig(remat="none"), tp, b)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    assert set(tg) == set(jg)
    for n, g in jg.items():
        np.testing.assert_allclose(tg[n].numpy(), np.asarray(g, np.float32),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
        assert torch.equal(tg[n], ng[n]), n
    assert torch.equal(tt, nt)


class _Count(TorchDispatchMode):
    """Counts aten ops by overload packet name."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _backward_counts(tcfg, tp, b, remat):
    leaves = {n: t.detach().requires_grad_() for n, t in tp.items()}
    total, _ = TLM.loss_fn(tcfg, leaves, b, ParallelConfig(remat=remat))
    with _Count() as c:
        torch.autograd.grad(total, list(leaves.values()))
    return c.n


@pytest.mark.parametrize("remat,mm,bmm", [("none", False, False),
                                          ("dots", False, True),
                                          ("full", True, True)])
def test_remat_recomputes_in_the_backward(world, remat, mm, bmm):
    """Ops of the backward beyond remat="none"'s are the recomputed
    forward: "dots" re-runs no ``aten.mm`` (their outputs are saved) but
    re-runs the ``aten.bmm``s (attention and the experts), "full" both,
    "none" neither."""
    _, tcfg, _, flat, b = world
    tp = convert_params(flat, tcfg, "cpu")
    base = _backward_counts(tcfg, tp, b, "none")
    got = _backward_counts(tcfg, tp, b, remat)
    extra = {k: got[k] - base[k] for k in ("mm", "bmm")}
    assert (extra["mm"] > 0) == mm, extra
    assert (extra["bmm"] > 0) == bmm, extra
    assert extra["mm"] >= 0 and extra["bmm"] >= 0, extra
