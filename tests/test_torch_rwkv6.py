"""The port's RWKV6 block (``repro_torch/models/rwkv6.py``) against the
JAX package's, function by function, in float32.

Inputs are made from numpy seeds and handed to both; the sublayers'
weights are random float32 arrays under the reference's names.
Tolerance: 1e-5 (the same float32 arithmetic, summed in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.models import rwkv6 as JR  # noqa: E402
from repro_torch.models import rwkv6 as TR  # noqa: E402

B, L, H, C = 2, 32, 2, 8
D = H * C
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.tensor(a)


def _close(want, got, **kw):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().numpy(), **(kw or TOL))


def test_token_shift():
    rng = np.random.default_rng(0)
    x, last = _rand(rng, B, L, D), _rand(rng, B, D)
    _close(JR.token_shift(jnp.asarray(x), jnp.asarray(last)),
           TR.token_shift(torch.tensor(x), torch.tensor(last)), rtol=0,
           atol=0)


def _wkv_inputs(seed):
    rng = np.random.default_rng(seed)
    r, k, v = (_rand(rng, B, L, H, C) for _ in range(3))
    logw = -rng.uniform(0.05, 2.0, (B, L, H, C)).astype(np.float32)
    return r, k, v, logw, _rand(rng, H, C)


@pytest.mark.parametrize("chunk", [8, L])          # several chunks, one
def test_wkv_chunked(chunk):
    """Output and final state of the chunked form at chunk 8 and at one
    chunk over the whole sequence, at 1e-5.  In one chunk of 32 the
    cumulative log decays reach about -33, and their float32 differences
    cancel: there the reference itself is 2.8e-5 from a float64
    evaluation (the port 1.8e-5) on outputs up to 21, so the atol is
    1e-5 of the largest output, and the port is also held within it of
    its own float64 evaluation."""
    args = _wkv_inputs(1)
    jo, jS = JR.wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    to, tS = TR.wkv_chunked(*map(torch.tensor, args), chunk=chunk)
    scale = 1.0 if chunk == 8 else float(np.abs(np.asarray(jo)).max())
    _close(jo, to, rtol=1e-5, atol=1e-5 * scale)
    _close(jS, tS)
    do, dS = TR.wkv_chunked(*(torch.tensor(a).double() for a in args),
                            chunk=chunk)
    _close(do, to, rtol=1e-5, atol=1e-5 * scale)
    _close(dS, tS)
    with pytest.raises(ValueError, match="multiple"):
        TR.wkv_chunked(*(torch.tensor(a[:, :L - 1]) if a.ndim == 4 else
                         torch.tensor(a) for a in args), chunk=8)


def _tm_params(seed, R=4):
    rng = np.random.default_rng(seed)
    p = {f"mu_{n}": _rand(rng, D, scale=0.3) for n in "rkvgw"}
    for n in ("wr", "wk", "wv", "wg", "wo"):
        p[n] = _rand(rng, D, D, scale=D ** -0.5)
    p.update(w_lora_a=_rand(rng, D, R, scale=D ** -0.5),
             w_lora_b=_rand(rng, R, D, scale=R ** -0.5),
             w0=_rand(rng, D, scale=0.3), u=_rand(rng, D, scale=0.3),
             ln_out=1 + _rand(rng, D, scale=0.1))
    return p


@pytest.mark.parametrize("path", ["chunked", "steps_from_state",
                                  "steps_ragged"])
def test_time_mix(path):
    """``rwkv6_time_mix`` on the chunked path (no state, L a multiple of
    the chunk), the per-token path from a given last row and state, and
    the per-token path taken when L is no multiple of the chunk: output,
    the last row and the final state."""
    rng = np.random.default_rng(2)
    p = _tm_params(3)
    n = L - 3 if path == "steps_ragged" else L
    x = _rand(rng, B, n, D)
    kw_j, kw_t = {}, {}
    if path == "steps_from_state":
        last, S = _rand(rng, B, D), _rand(rng, B, H, C, C, scale=0.5)
        kw_j = dict(last_x=jnp.asarray(last), state=jnp.asarray(S))
        kw_t = dict(last_x=torch.tensor(last), state=torch.tensor(S))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jo, (jl, jS) = JR.rwkv6_time_mix(jnp.asarray(x), jp, H, 8, **kw_j)
    to, (tl, tS) = TR.rwkv6_time_mix(torch.tensor(x), tp, H, 8, **kw_t)
    _close(jo, to)
    _close(jl, tl, rtol=0, atol=0)
    _close(jS, tS)


@pytest.mark.parametrize("with_last", [False, True])
def test_channel_mix(with_last):
    rng = np.random.default_rng(4)
    F_ = 24
    p = dict(mu_k=_rand(rng, D, scale=0.3), mu_r=_rand(rng, D, scale=0.3),
             wk=_rand(rng, D, F_, scale=D ** -0.5),
             wv=_rand(rng, F_, D, scale=F_ ** -0.5),
             wr=_rand(rng, D, D, scale=D ** -0.5))
    x = _rand(rng, B, L, D)
    last = _rand(rng, B, D) if with_last else None
    jo, jl = JR.rwkv6_channel_mix(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        None if last is None else jnp.asarray(last))
    to, tl = TR.rwkv6_channel_mix(
        torch.tensor(x), {k: torch.tensor(v) for k, v in p.items()},
        None if last is None else torch.tensor(last))
    _close(jo, to)
    _close(jl, tl, rtol=0, atol=0)
