"""The port's Mamba2 block (``repro_torch/models/mamba2.py``) against the
JAX package's, function by function, in float32.

Inputs are made from numpy seeds and handed to both; the block's weights
are random float32 arrays under the reference's names.  Tolerance: 1e-5
(the same float32 arithmetic, summed in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.common.types import SSMConfig  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402

B, L, DM = 2, 32, 16
SSM = SSMConfig(d_state=8, d_conv=4, expand=2, headdim=8, chunk=8)
DI = SSM.expand * DM
H, N, P, K = DI // SSM.headdim, SSM.d_state, SSM.headdim, SSM.d_conv
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(want, got, **kw):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().numpy(), **(kw or TOL))


def test_softplus_matches_jax_past_torch_threshold():
    """``jax.nn.softplus`` on both sides of 20, where ``F.softplus``
    switches to x itself."""
    x = np.array([-40, -20, -1, 0, 1, 19.5, 20, 20.5, 25, 40, 90],
                 np.float32)
    _close(jax.nn.softplus(jnp.asarray(x)), TM.softplus(torch.tensor(x)),
           rtol=0, atol=0)


def test_causal_conv1d():
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, B, L, DI), _rand(rng, DI, K), _rand(rng, DI)
    _close(JM.causal_conv1d(*map(jnp.asarray, (x, w, b))),
           TM.causal_conv1d(*map(torch.tensor, (x, w, b))))


@pytest.mark.parametrize("chunk", [8, L])
def test_ssd_chunked(chunk):
    """Output and final state at chunk 8 and at one chunk; a length that
    is no multiple of the chunk raises, as the reference asserts."""
    rng = np.random.default_rng(1)
    xh = _rand(rng, B, L, H, P)
    dt = rng.uniform(0.01, 1.0, (B, L, H)).astype(np.float32)
    args = (xh, dt, _rand(rng, H, scale=0.5), _rand(rng, B, L, N),
            _rand(rng, B, L, N))
    jy, js = JM.ssd_chunked(*map(jnp.asarray, args), chunk)
    ty, ts = TM.ssd_chunked(*map(torch.tensor, args), chunk)
    _close(jy, ty)
    _close(js, ts)
    with pytest.raises(ValueError, match="multiple"):
        TM.ssd_chunked(*(torch.tensor(a[:, :L - 2]) if a.ndim > 1 else
                         torch.tensor(a) for a in args), 8)


class _Cfg:
    d_model = DM


def _params(seed, dt_bias=0.0):
    rng = np.random.default_rng(seed)
    s = DM ** -0.5
    return dict(
        norm=1 + _rand(rng, DM, scale=0.1), wz=_rand(rng, DM, DI, scale=s),
        wx=_rand(rng, DM, DI, scale=s), wbc=_rand(rng, DM, 2 * N, scale=s),
        wdt=_rand(rng, DM, H, scale=s),
        dt_bias=np.full(H, dt_bias, np.float32) + _rand(rng, H, scale=0.1),
        A_log=_rand(rng, H, scale=0.5), D=1 + _rand(rng, H, scale=0.1),
        conv_x_w=_rand(rng, DI, K, scale=0.2), conv_x_b=_rand(rng, DI,
                                                              scale=0.1),
        conv_bc_w=_rand(rng, 2 * N, K, scale=0.2),
        conv_bc_b=_rand(rng, 2 * N, scale=0.1),
        norm_inner=1 + _rand(rng, DI, scale=0.1),
        wo=_rand(rng, DI, DM, scale=DI ** -0.5))


def _run(p, x, train, state=None):
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    js = None if state is None else {k: jnp.asarray(v)
                                     for k, v in state.items()}
    ts = None if state is None else {k: torch.tensor(v)
                                     for k, v in state.items()}
    jo, jst = JM.mamba2_forward(jnp.asarray(x), jp, _Cfg, SSM, train, js)
    to, tst = TM.mamba2_forward(torch.tensor(x), tp, _Cfg, SSM, train, ts)
    return jo, jst, to, tst


@pytest.mark.parametrize("dt_bias", [0.0, 21.0])    # 21: past softplus's 20
def test_mamba2_forward_train_prefill_decode(dt_bias):
    """Training (no state returned), prefill (the final SSM state and the
    PRE-conv inputs of the last K-1 positions) and one decode step from
    that state; ``dt_bias`` 21 puts dt across softplus's threshold."""
    rng = np.random.default_rng(5)
    p = _params(6, dt_bias)
    x = _rand(rng, B, L, DM)
    if dt_bias:
        h = x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-5) * p["norm"]
        dt = h @ p["wdt"] + p["dt_bias"]
        assert (dt < 20).any() and (dt > 20).any()
    jo, jst, to, tst = _run(p, x, True)
    _close(jo, to)
    assert jst is None and tst is None
    jo, jst, to, tst = _run(p, x, False)
    _close(jo, to)
    assert set(jst) == set(tst) == {"ssm", "conv_x", "conv_bc"}
    for n in jst:
        assert tuple(jst[n].shape) == tuple(tst[n].shape), n
        _close(jst[n], tst[n])
    state = {n: np.asarray(a) for n, a in jst.items()}
    jo, jst, to, tst = _run(p, _rand(rng, B, 1, DM), False, state)
    _close(jo, to)
    for n in jst:
        _close(jst[n], tst[n])
