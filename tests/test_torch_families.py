"""Every family of the port's model zoo against the JAX package's, on the
smoke config of each architecture in ``ARCHS``: dense (GQA, MQA with
GeGLU, QKV bias, tied embeddings, the plain GELU MLP), vlm (patches
before tokens), audio (frames in place of tokens), rwkv, hybrid
(Mamba2 groups around one shared attention + MLP block), moe and moe
with a shared expert.

One module-scoped fixture per architecture carries the JAX package's
float32 parameters over with ``convert_params`` and jits each JAX
function once.  Inputs are made from numpy seeds and handed to both.
Tolerances: float32 logits, caches and decode steps at 1e-4 (the same
arithmetic, summed in another order, through a few layers and the
head); the loss at 1e-5 and gradients at rtol 1e-4 / atol 1e-6, as
``tests/test_torch_train.py`` holds them; bfloat16 at the reference's
own decode-vs-prefill tolerance, 5e-2 (tests/test_models.py)."""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.common.types import TrainConfig as JTrain  # noqa: E402
from repro.configs.registry import ARCHS  # noqa: E402
from repro.configs.registry import get as j_get  # noqa: E402
from repro.configs.registry import get_smoke as j_get_smoke  # noqa: E402
from repro.launch.steps import make_prefill_step  # noqa: E402
from repro.launch.steps import make_serve_step  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.common.types import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs.registry import get, get_smoke  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch.steps import grads_of, make_train_step  # noqa: E402
from repro_torch.launch.steps import \
    make_prefill_step as t_prefill  # noqa: E402
from repro_torch.launch.steps import make_serve_step as t_serve  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from test_torch_train import _check_params  # noqa: E402

B, L, LP, GEN = 2, 32, 16, 16      # LP, L: multiples of every smoke chunk
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(a):
    return np.asarray(a, np.float32)


def _close(want, got, msg="", **kw):
    np.testing.assert_allclose(_np(want), got.detach().float().numpy(),
                               err_msg=msg, **(kw or TOL))


def _cfgs(arch, dtype):
    return (dataclasses.replace(j_get_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke(arch), dtype=dtype))


def _batch(cfg, seed, n, labels=False):
    """n positions of input: the audio stub's frames; the vision stub's
    patches, then tokens; else tokens.  With next-token labels, some
    masked."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.frontend == "audio_stub":
        b["frames"] = rng.standard_normal((B, n, cfg.d_model)).astype(
            np.float32)
    else:
        nt = n
        if cfg.frontend == "vision_stub":
            nt -= cfg.n_frontend_tokens
            b["patches"] = rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, nt)).astype(
            np.int32)
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
        b["labels"][0, :5] = -1
    return b


def _prefix(cfg, b, n):
    """The first n positions of a _batch."""
    out = {}
    for k, a in b.items():
        if k == "tokens" and cfg.frontend == "vision_stub":
            out[k] = a[:, :n - cfg.n_frontend_tokens]
        elif k != "patches":
            out[k] = a[:, :n]
        else:
            out[k] = a
    return out


def _step_input(cfg, b, i):
    """Position i of a _batch as a decode step's input."""
    if cfg.frontend == "audio_stub":
        return {"frames": b["frames"][:, i]}
    if cfg.frontend == "vision_stub":
        i -= cfg.n_frontend_tokens
    return {"tokens": b["tokens"][:, i]}


def _jx(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tt(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def _jinit(cfg, seed):
    """The reference's random parameters, its init jitted once (fewer
    compiles than its eager per-leaf draws)."""
    return jax.jit(JLM.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(seed))


def _jpad(cache, n):
    """The reference serve's padding: K/V only, along dim -3."""
    def padk(a):
        w = [(0, 0)] * a.ndim
        w[-3] = (0, n)
        return jnp.pad(a, w)
    return {k: padk(a) if k in ("k", "v") else a for k, a in cache.items()}


@pytest.fixture(scope="module", params=ARCHS)
def world(request):
    """Float32: the JAX package's parameters and jitted functions, and
    the port's flat parameters and LM over them, on the CPU."""
    jcfg, tcfg = _cfgs(request.param, "float32")
    jparams = _jinit(jcfg, 0)
    flat = {n: _np(a) for n, a in JP.flatten(jparams).items()}
    tparams = convert_params(flat, tcfg, "cpu")
    batch = SyntheticLM(tcfg, L, B).batch(0)
    batch["labels"][0, :5] = -1
    jb = _jx(batch)

    @functools.cache
    def jgrads():
        """((total, metrics), gradients) of the reference's loss_fn on
        ``batch``, by ``jax.value_and_grad``: the reference train step's
        own gradients (microbatch 1)."""
        return jax.jit(jax.value_and_grad(
            lambda p: JLM.loss_fn(jcfg, p, jb), has_aux=True))(jparams)

    return SimpleNamespace(batch=batch, jgrads=jgrads,
        arch=request.param, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
        flat=flat, tparams=tparams, model=TLM.LM(tcfg, tparams),
        forward=jax.jit(lambda p, b: JLM.forward(jcfg, p, b,
                                                 collect_cache=True)),
        prefill=jax.jit(make_prefill_step(jcfg)),
        step=jax.jit(make_serve_step(jcfg)))


# ---------------------------------------------------------- definitions --

@pytest.mark.parametrize("arch", ARCHS)
def test_build_defs_matches_jax(arch):
    """Names, shapes, logical axes, init styles, scales and dtypes, for
    the registry's full config and its smoke config; the decode cache's
    layout too."""
    for jc, tc in ((j_get(arch), get(arch)), (j_get_smoke(arch),
                                              get_smoke(arch))):
        jd, td = JLM.build_defs(jc), TLM.build_defs(tc)
        assert list(td) == list(jd)
        for n, d in jd.items():
            assert dataclasses.astuple(td[n]) == dataclasses.astuple(d), n
        js, ts = JD.cache_spec(jc, 3, 40), TD.cache_spec(tc, 3, 40)
        assert list(ts) == list(js)
        for n, (shape, dt, axes) in js.items():
            assert ts[n][0] == tuple(shape) and ts[n][2] == axes, n
            assert str(ts[n][1]) == f"torch.{np.dtype(dt).name}", n


# -------------------------------------------------------------- forward --

def test_forward_matches_jax(world):
    """Logits, every cache entry and the auxiliary loss of a prefill over
    L positions; the training forward on the flat dict equals the LM's
    modules bit for bit."""
    w = world
    b = _batch(w.tcfg, 0, L)
    jl, jc, jaux = w.forward(w.jparams, _jx(b))
    tl, tc, taux = TLM.forward(w.tcfg, w.model, _tt(b), collect_cache=True)
    _close(jl, tl)
    assert set(tc) == set(jc)
    for n in jc:
        assert tuple(tc[n].shape) == tuple(jc[n].shape), n
        _close(jc[n], tc[n], n)
    np.testing.assert_allclose(float(jaux["moe_aux"]),
                               float(taux["moe_aux"]), rtol=1e-5, atol=1e-7)
    dl, dc, daux = TLM.forward(w.tcfg, w.tparams, _tt(b), collect_cache=True)
    assert torch.equal(dl, tl)
    assert all(torch.equal(dc[n], tc[n]) for n in tc)
    assert torch.equal(daux["moe_aux"], taux["moe_aux"])


def test_prefill_and_decode_match_jax(world):
    """Prefill LP positions (logits and every cache entry), pad the K/V to
    L, then teacher-force 8 positions through ``decode_step`` on both:
    each step's logits, and every cache entry after the last, within
    1e-4; each step's logits also equal the port's own full forward at
    that position."""
    w = world
    cfg = w.tcfg
    b = _batch(cfg, 1, L)
    full, _, _ = TLM.forward(cfg, w.model, _tt(b))
    jlast, jc = w.prefill(w.jparams, _jx(_prefix(cfg, b, LP)))
    tlast, tc = t_prefill(cfg)(w.model, _tt(_prefix(cfg, b, LP)))
    _close(jlast, tlast)
    assert set(tc) == set(jc)
    for n in jc:
        _close(jc[n], tc[n], n)
    jc, tc = _jpad(jc, L - LP), TS.pad_cache(tc, L - LP)
    spec = TD.cache_spec(cfg, B, L)
    assert {n: tuple(a.shape) for n, a in tc.items()} == {
        n: s for n, (s, _, _) in spec.items()}
    assert all(tc[n].dtype == d for n, (_, d, _) in spec.items())
    for i in range(LP, LP + 8):
        pos = np.full((B,), i, np.int32)
        x = _step_input(cfg, b, i)
        jl, jc = w.step(w.jparams, jc, dict(_jx(x), pos=jnp.asarray(pos)))
        tl, tc = t_serve(cfg)(w.model, tc, dict(_tt(x),
                                                pos=torch.tensor(pos)))
        _close(jl, tl, f"position {i}")
        _close(full[:, i], tl, f"position {i} against the forward",
               rtol=1e-4, atol=1e-4)
    for n in jc:
        _close(jc[n], tc[n], n)


# ------------------------------------------------------------- training --

def test_loss_and_gradients_match_jax(world):
    """total, loss, zloss and moe_aux at rtol 1e-5 (a ``SyntheticLM``
    batch, some labels masked), and every leaf's gradient against
    ``jax.value_and_grad`` at rtol 1e-4 / atol 1e-6, or 1e-5 of the
    leaf's largest gradient where that is more: RWKV's embedding
    gradient reaches 2.4 (the rms_norm of 0.02-scale embeddings amplifies
    it), and there both packages are 4-6e-6 from a float64 evaluation."""
    w = world
    (jt, jm), jg = w.jgrads()
    tt, tm = TLM.loss_fn(w.tcfg, w.tparams, _tt(w.batch))
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    for k in ("loss", "zloss", "moe_aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    total, tg = grads_of(w.tcfg, None, w.tparams, w.batch)
    assert float(total) == float(tt)
    jg = JP.flatten(jg)
    assert set(tg) == set(jg)
    for n, g in jg.items():
        g = _np(g)
        np.testing.assert_allclose(tg[n].numpy(), g, rtol=1e-4, atol=max(
            1e-6, 1e-5 * float(np.abs(g).max())), err_msg=n)


def test_train_step_matches_jax(world):
    """One ``make_train_step`` with float32 moments against the
    reference's step (its AdamW ``apply_updates`` on its own gradients,
    which is its ``make_train_step`` at microbatch 1): loss, grad norm
    and lr at rtol 1e-5, the parameters after the step as
    ``test_torch_train`` holds them; ``remat="full"`` (per layer, per
    group for hybrid) gives the same parameters bit for bit."""
    w = world
    (jt, _), jg = w.jgrads()
    jo = JA.init_state(w.jparams, "float32")
    jp, _, jm = jax.jit(lambda p, g, o: JA.apply_updates(
        p, g, o, JTrain(warmup_steps=2), "float32"))(w.jparams, jg, jo)
    par = dict(remat="none", microbatch=1, moment_dtype="float32")
    out = {}
    for remat in ("none", "full"):
        tp = convert_params(w.flat, w.tcfg, "cpu")
        step = make_train_step(w.tcfg, ParallelConfig(**dict(par,
                                                            remat=remat)),
                               TrainConfig(warmup_steps=2))
        _, _, tm = step(tp, TA.init_state(tp, "float32"), w.batch)
        out[remat] = tp
        np.testing.assert_allclose(float(tm["loss"]), float(jt), rtol=1e-5)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
    _check_params(jp, out["none"], jo, float(jm["lr"]), "float32")
    assert all(torch.equal(out["none"][n], out["full"][n])
               for n in out["none"])


def _jax_expert_sets(cfg, params, batch):
    """Each MoE layer's sorted top-k experts per token [layers, T, k], by
    the reference's own block bodies under ``lax.scan``, as its forward
    runs them."""
    x = JLM.embed_inputs(cfg, params, batch)
    B, n, _ = x.shape
    cos, sin = JL.rope_cos_sin(jnp.arange(n, dtype=jnp.int32)[None],
                               cfg.resolved_head_dim(), cfg.rope_theta)
    cap = JM.capacity_for(B * n, cfg.moe)

    def body(x, lp):
        x, _ = JLM._attn_block(cfg, lp, x, "", cos, sin, cfg.q_chunk,
                               cfg.kv_chunk)
        x, plan = JLM._moe_block(cfg, lp, x, cap)
        return x, jnp.sort(plan["ids"], axis=-1)
    return jax.lax.scan(body, x, params["layers"])[1]


def _routed_alike(jcfg, jparams, tcfg, model, b):
    """[B, n] bool: the (row, position) pairs before which every MoE layer
    chose the same experts for every token of the row in both packages
    (a bf16 near-tie in the router may flip one expert, which moves the
    row's later logits by that expert's whole contribution)."""
    seen = []
    hooks = [layer.moe.register_forward_hook(
        lambda mod, args, out: seen.append(out[1]["ids"].sort(-1).values))
        for layer in model.layers]
    try:
        TLM.forward(tcfg, model, _tt(b))
    finally:
        for h in hooks:
            h.remove()
    want = np.asarray(jax.jit(lambda p, b: _jax_expert_sets(jcfg, p, b))(
        jparams, _jx(b)))
    got = torch.stack(seen).numpy()
    n_layers, T, k = want.shape
    moved = (want != got).any(-1).any(0).reshape(B, T // B)
    return ~np.maximum.accumulate(moved, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_matches_jax(arch):
    """bfloat16 parameters (JAX's own, carried over bit for bit) and
    activations: logits within 5e-2 of the logits' scale (1 + the largest
    |logit|).  The scale, not each logit, bounds the error: two bf16
    evaluations round differently (XLA keeps fused elementwise chains in
    float32, torch rounds each op), and a logit is a d_model-term dot
    product whose rounding follows the size of its terms.  The MoE
    families are held on the (row, position) pairs routed alike in both
    packages, which must be most of them."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jparams = _jinit(jcfg, 3)
    flat = {n: np.asarray(a) for n, a in JP.flatten(jparams).items()}
    b = _batch(tcfg, 4, L)
    jl, _, _ = jax.jit(lambda p, b: JLM.forward(jcfg, p, b))(jparams, _jx(b))
    model = TLM.LM(tcfg, convert_params(flat, tcfg, "cpu"))
    tl, _, _ = TLM.forward(tcfg, model, _tt(b))
    jl, tl = _np(jl), tl.numpy()
    alike = np.ones(jl.shape[:2], bool)
    if tcfg.family == "moe":
        alike = _routed_alike(jcfg, jparams, tcfg, model, b)
        assert 2 * alike.sum() >= alike.size, alike
    np.testing.assert_allclose(tl[alike], jl[alike], rtol=0,
                               atol=5e-2 * (1 + np.abs(jl).max()))


# -------------------------------------------------------------- serving --

def test_generate_matches_jax_serve_loop(world):
    """The port's greedy ``generate`` over an LP-position prompt (with
    the stubs' patches or frames) and GEN steps, against the reference
    ``serve`` loop (prefill, K/V padded to LP + GEN, decode steps) fed
    the port's tokens: every step's logits within 1e-4, and the greedy
    token equal to JAX's argmax wherever JAX's top-2 margin exceeds
    1e-3.  The audio stub decodes the given frames."""
    w = world
    cfg = w.tcfg
    b = _prefix(cfg, _batch(cfg, 5, L), LP)
    frames = None
    if cfg.frontend == "audio_stub":
        frames = np.random.default_rng(6).standard_normal(
            (B, GEN - 1, cfg.d_model)).astype(np.float32)
    out = TS.generate(cfg, w.model, b, GEN, "cpu", frames)
    assert out.tokens.shape == (B, GEN) and out.tokens.dtype == torch.int32
    assert out.logits.shape == (B, GEN, cfg.vocab_size)
    jl, jc = w.prefill(w.jparams, _jx(b))
    jc = _jpad(jc, GEN)
    for i in range(GEN):
        if i:
            x = ({"frames": jnp.asarray(frames[:, i - 1])} if frames is not
                 None else {"tokens": jnp.asarray(out.tokens[:, i - 1]
                                                  .numpy())})
            jl, jc = w.step(w.jparams, jc, dict(
                x, pos=jnp.full((B,), LP + i - 1, jnp.int32)))
        jl = _np(jl)
        _close(jl, out.logits[:, i], f"step {i}")
        top2 = np.sort(jl, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 1e-3
        np.testing.assert_array_equal(jl.argmax(-1)[sure],
                                      out.tokens[:, i].numpy()[sure])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_cpu(arch):
    """The launcher's ``serve`` on the CPU for every family: greedy tokens
    of the right shape and range."""
    toks = TS.serve(arch, True, 2, LP, 4, device="cpu")
    assert toks.shape == (2, 4) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < get_smoke(arch).vocab_size)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_defaults_to_cuda(arch, monkeypatch):
    """Without --device the launcher asks for cuda for every family: it
    raises where there is none and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.main()


def _drift(logits, full, lp):
    """Each decode step's largest relative L2 difference from the full
    forward's logits at that position (over rows)."""
    want = full[:, lp - 1:]
    return (np.linalg.norm(logits - want, axis=-1)
            / np.linalg.norm(want, axis=-1)).max(0)


@pytest.mark.parametrize("arch,lp", [("rwkv6_7b", 240), ("zamba2_2p7b", 128)])
def test_bf16_decode_drift_matches_jax(arch, lp):
    """The recurrent families in bfloat16, 8 rows of 256 tokens: prefill
    ``lp``, teacher-force the rest through decode in both packages (the
    same bf16 parameters).  Their states carry bf16 rounding forward
    through the decays, so decode drifts from the full forward in the
    reference too; the port's largest drift (relative L2 of a position's
    logits) is at most 1.25 times the reference's."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jparams = _jinit(jcfg, 0)
    model = TLM.LM(tcfg, convert_params(
        {n: np.asarray(a) for n, a in JP.flatten(jparams).items()}, tcfg,
        "cpu"))
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (8, 256))
    full = _np(jax.jit(lambda p, b: JLM.forward(jcfg, p, b)[0])(
        jparams, {"tokens": jnp.asarray(toks)}))
    last, cache = jax.jit(make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(toks[:, :lp])})
    cache, step, outs = _jpad(cache, 256 - lp), jax.jit(make_serve_step(
        jcfg)), [_np(last)]
    for i in range(lp, 256):
        lg, cache = step(jparams, cache, {"tokens": jnp.asarray(toks[:, i]),
                                          "pos": jnp.full((8,), i,
                                                          jnp.int32)})
        outs.append(_np(lg))
    want = _drift(np.stack(outs, 1), full, lp)
    tt = torch.tensor(toks)
    with torch.inference_mode():
        tfull = TLM.forward(tcfg, model, {"tokens": tt})[0].float().numpy()
        last, cache = t_prefill(tcfg)(model, {"tokens": tt[:, :lp]})
        cache, outs = TS.pad_cache(cache, 256 - lp), [last.float().numpy()]
        for i in range(lp, 256):
            lg, cache = t_serve(tcfg)(model, cache, {
                "tokens": tt[:, i], "pos": torch.full((8,), i,
                                                      dtype=torch.int32)})
            outs.append(lg.float().numpy())
    got = _drift(np.stack(outs, 1), tfull, lp)
    assert want.max() > 0.01                # the reference drifts too
    assert got.max() <= 1.25 * want.max(), (got.max(), want.max())
