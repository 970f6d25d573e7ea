"""The port's Qwen3-MoE serving path against the JAX package's, module by
module and end to end, on ``get_smoke("qwen3_moe_235b_a22b")``.

The JAX package's parameters are carried over with ``convert_params``;
inputs are made from numpy seeds and handed to both.  Tolerances: float32
results at 1e-5 per layer (the same arithmetic, summed in another order)
and 1e-4 for logits after two layers and the head; routing plans (integer
order, slots, admission) exactly, since the kernel's positions are exact
and float32 router probabilities do not tie; bfloat16 at the reference's
own decode-vs-prefill tolerance, 5e-2 (tests/test_models.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.registry import get_smoke as j_get_smoke  # noqa: E402
from repro.launch.steps import make_prefill_step  # noqa: E402
from repro.launch.steps import make_serve_step  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro_torch.configs.registry import get_smoke  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch.steps import \
    make_prefill_step as t_prefill  # noqa: E402
from repro_torch.launch.steps import make_serve_step as t_serve  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

ARCH = "qwen3_moe_235b_a22b"
B, L = 2, 32


def _cfgs(dtype):
    return (dataclasses.replace(j_get_smoke(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke(ARCH), dtype=dtype))


def _np(a):
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def world():
    """Float32: (JAX cfg, port cfg, JAX params, port LM on the CPU)."""
    jcfg, tcfg = _cfgs("float32")
    jparams = JLM.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {n: _np(a) for n, a in JP.flatten(jparams).items()}
    return jcfg, tcfg, jparams, TLM.LM(tcfg, convert_params(flat, tcfg,
                                                             "cpu"))


def j_prefill(cfg):
    return jax.jit(make_prefill_step(cfg))


def j_serve(cfg):
    return jax.jit(make_serve_step(cfg))


def _tokens(seed, cfg, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


# ------------------------------------------------------------ layers ----

def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", ["rms_norm", "apply_rope",
                                  "attention_one_block",
                                  "attention_blocks", "attention_offset",
                                  "decode_attention"])
def test_layers_match_jax(case):
    rng = np.random.default_rng(7)
    t, j = torch.tensor, jnp.asarray
    if case == "rms_norm":
        x, s = _rand(rng, 3, 5, 64), _rand(rng, 64)
        want, got = JL.rms_norm(j(x), j(s)), TL.rms_norm(t(x), t(s))
    elif case == "apply_rope":
        x = _rand(rng, 2, 9, 4, 16)
        pos = rng.integers(0, 500, (2, 9)).astype(np.int32)
        jc, js = JL.rope_cos_sin(j(pos), 16, 1e4)
        tc, ts = TL.rope_cos_sin(t(pos), 16, 1e4)
        np.testing.assert_allclose(_np(jc), tc.numpy(), rtol=1e-5, atol=1e-5)
        want, got = JL.apply_rope(j(x), jc, js), TL.apply_rope(t(x), tc, ts)
    elif case.startswith("attention"):
        q, k, v = (_rand(rng, 2, 32, 4, 16), _rand(rng, 2, 32, 2, 16),
                   _rand(rng, 2, 32, 2, 16))
        qc, kc, off = {"attention_one_block": (32, 32, 0),
                       "attention_blocks": (8, 16, 0),
                       "attention_offset": (16, 8, 5)}[case]
        want = JL.chunked_causal_attention(j(q), j(k), j(v), qc, kc, off)
        got = TL.chunked_causal_attention(t(q), t(k), t(v), qc, kc, off)
    else:
        q, kc, vc = (_rand(rng, 3, 4, 16), _rand(rng, 3, 20, 2, 16),
                     _rand(rng, 3, 20, 2, 16))
        lengths = np.array([1, 7, 20], np.int32)
        want = JL.decode_attention(j(q), j(kc), j(vc), j(lengths))
        got = TL.decode_attention(t(q), t(kc), t(vc), t(lengths))
    np.testing.assert_allclose(_np(want), got.numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- MoE ----

def _moe_inputs(world, seed, T):
    jcfg, tcfg, jparams, model = world
    x = _rand(np.random.default_rng(seed), T, tcfg.d_model)
    lp = {n: a[0] for n, a in jparams["layers"].items()}
    return jcfg, tcfg, lp, model.layers[0].moe.weights(), x


@pytest.mark.parametrize("capacity", [None, 8])     # None: capacity_for
def test_route_plan_matches_jax(world, capacity):
    """The routing plan is equal: order, slots, admission, source tokens
    and expert ids exactly; gates and probabilities at 1e-6.  Capacity 8
    for 64 tokens x top-2 over 8 experts drops tokens."""
    jcfg, tcfg, lp, tp, x = _moe_inputs(world, 1, 64)
    cap = capacity or TM.capacity_for(64, tcfg.moe)
    assert cap == (capacity or JM.capacity_for(64, jcfg.moe))
    jplan = JM.route(jnp.asarray(x), lp["router"], jcfg.moe, cap)
    tplan = TM.route(torch.tensor(x), tp["router"], tcfg.moe, cap)
    assert set(jplan) == set(tplan)
    for k in ("order", "slot", "admit", "tok", "ids"):
        np.testing.assert_array_equal(np.asarray(jplan[k]),
                                      tplan[k].numpy(), err_msg=k)
    for k in ("gate", "probs"):
        np.testing.assert_allclose(np.asarray(jplan[k]), tplan[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    n_drop = int((~tplan["admit"]).sum())
    assert (n_drop > 0) == (capacity is not None)


@pytest.mark.parametrize("capacity", [None, 8])
def test_moe_ffn_matches_jax(world, capacity):
    jcfg, tcfg, lp, tp, x = _moe_inputs(world, 2, 64)
    cap = capacity or TM.capacity_for(64, tcfg.moe)
    jy, _ = JM.moe_ffn(jnp.asarray(x), dict(
        router=lp["router"], w_gate=lp["e_gate"], w_up=lp["e_up"],
        w_down=lp["e_down"]), jcfg.moe, jax.nn.silu, cap)
    ty, _ = TM.moe_ffn(torch.tensor(x), dict(
        router=tp["router"], w_gate=tp["e_gate"], w_up=tp["e_up"],
        w_down=tp["e_down"]), tcfg.moe, torch.nn.functional.silu, cap)
    np.testing.assert_allclose(_np(jy), ty.numpy(), rtol=1e-5, atol=1e-5)
    jl = JM.load_balance_loss(*(lambda p: (p["probs"], p["ids"]))(
        JM.route(jnp.asarray(x), lp["router"], jcfg.moe, cap)), 8)
    tplan = TM.route(torch.tensor(x), tp["router"], tcfg.moe, cap)
    tl = TM.load_balance_loss(tplan["probs"], tplan["ids"], 8)
    np.testing.assert_allclose(float(jl), float(tl), rtol=1e-5)


# ------------------------------------------------------- end to end ----

def test_forward_matches_jax(world):
    """Logits, the KV cache and the auxiliary loss of a prefill."""
    jcfg, tcfg, jparams, model = world
    toks = _tokens(0, tcfg, (B, L))
    jl, jc, jaux = JLM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                               collect_cache=True)
    tl, tc, taux = TLM.forward(tcfg, model, {"tokens": torch.tensor(toks)},
                               collect_cache=True)
    np.testing.assert_allclose(_np(jl), tl.numpy(), rtol=1e-4, atol=1e-4)
    for n in ("k", "v"):
        assert tuple(jc[n].shape) == tuple(tc[n].shape)
        np.testing.assert_allclose(_np(jc[n]), tc[n].numpy(), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(float(jaux["moe_aux"]),
                               float(taux["moe_aux"]), rtol=1e-5)


def test_decode_step_matches_jax(world):
    """Prefill 16 tokens, pad the cache to 32, then teacher-force the next
    8 through decode_step on both: logits at every step within 1e-4."""
    jcfg, tcfg, jparams, model = world
    toks, lp = _tokens(1, tcfg, (B, L)), 16
    jlast, jc = j_prefill(jcfg)(jparams, {"tokens": jnp.asarray(toks[:, :lp])})
    tlast, tc = t_prefill(tcfg)(model,
                                        {"tokens": torch.tensor(toks[:, :lp])})
    np.testing.assert_allclose(_np(jlast), tlast.numpy(), rtol=1e-4,
                               atol=1e-4)
    jc = {n: jnp.pad(a, [(0, 0), (0, 0), (0, L - lp), (0, 0), (0, 0)])
          for n, a in jc.items()}
    tc = {n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, L - lp))
          for n, a in tc.items()}
    assert tuple(tc["k"].shape) == TD.cache_spec(tcfg, B, L)["k"][0]
    jstep, tstep = j_serve(jcfg), t_serve(tcfg)
    for i in range(lp, lp + 8):
        pos = np.full((B,), i, np.int32)
        jl, jc = jstep(jparams, jc, {"tokens": jnp.asarray(toks[:, i]),
                                     "pos": jnp.asarray(pos)})
        tl, tc = tstep(model, tc, {"tokens": torch.tensor(toks[:, i]),
                                   "pos": torch.tensor(pos)})
        np.testing.assert_allclose(_np(jl), tl.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"position {i}")
    np.testing.assert_allclose(_np(jc["k"]), tc["k"].numpy(), rtol=1e-4,
                               atol=1e-4)


def test_decode_matches_own_forward(world):
    """The port's KV cache on its own: prefill 16 tokens, then teacher-
    force the other 16 through decode_step; each step's logits equal the
    full forward's at that position within 1e-4 (float32; the smoke
    config's capacity drops nothing, so both paths route alike)."""
    _, tcfg, _, model = world
    toks = torch.tensor(_tokens(5, tcfg, (B, L)))
    full, _, _ = TLM.forward(tcfg, model, {"tokens": toks})
    _, cache = t_prefill(tcfg)(model, {"tokens": toks[:, :16]})
    cache = {n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, L - 16))
             for n, a in cache.items()}
    for i in range(16, L):
        logits, cache = t_serve(tcfg)(model, cache, {
            "tokens": toks[:, i], "pos": torch.full((B,), i,
                                                    dtype=torch.int32)})
        torch.testing.assert_close(logits, full[:, i], rtol=1e-4, atol=1e-4)


def test_generate_matches_jax_teacher_forced(world):
    """The port's greedy generate over 4 decode steps; JAX is fed the
    port's tokens.  Logits of every step within 1e-4; the greedy token
    equals JAX's argmax wherever JAX's top-2 margin exceeds 1e-3."""
    jcfg, tcfg, jparams, model = world
    toks, gen = _tokens(2, tcfg, (B, 12)), 5
    out = TS.generate(tcfg, model, {"tokens": toks}, gen, "cpu")
    assert out.tokens.shape == (B, gen) and out.logits.shape == (
        B, gen, tcfg.vocab_size)
    jl, jc = j_prefill(jcfg)(jparams, {"tokens": jnp.asarray(toks)})
    jc = {n: jnp.pad(a, [(0, 0), (0, 0), (0, gen), (0, 0), (0, 0)])
          for n, a in jc.items()}
    jstep = j_serve(jcfg)
    for i in range(gen):
        if i:
            jl, jc = jstep(jparams, jc, {
                "tokens": jnp.asarray(out.tokens[:, i - 1].numpy()),
                "pos": jnp.full((B,), 12 + i - 1, jnp.int32)})
        jl = _np(jl)
        np.testing.assert_allclose(jl, out.logits[:, i].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {i}")
        top2 = np.sort(jl, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 1e-3
        np.testing.assert_array_equal(jl.argmax(-1)[sure],
                                      out.tokens[:, i].numpy()[sure])


def test_forward_bf16_matches_jax():
    """bfloat16 parameters and activations: logits within 5e-2."""
    jcfg, tcfg = _cfgs("bfloat16")
    jparams = JLM.init_params(jcfg, jax.random.PRNGKey(3))
    flat = {n: _np(a) for n, a in JP.flatten(jparams).items()}
    toks = _tokens(4, tcfg, (B, L))
    jl, _, _ = JLM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl, _, _ = TLM.forward(tcfg, convert_params(flat, tcfg, "cpu"),
                           {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(_np(jl), tl.numpy(), rtol=5e-2, atol=5e-2)


def test_serve_smoke_on_cpu():
    toks = TS.serve("qwen3-moe-235b-a22b", True, 3, 16, 4, device="cpu")
    cfg = get_smoke(ARCH)
    assert toks.shape == (3, 4) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()


# ---------------------------------------------------------- parameters --

def test_convert_params_round_trip():
    """JAX init -> flatten -> float32 numpy -> the port: the same names,
    shapes, dtypes and values; bfloat16 arrays straight from JAX convert
    bit for bit; a missing or extra name and a wrong shape raise."""
    jcfg, tcfg = _cfgs("bfloat16")
    jflat = JP.flatten(JLM.init_params(jcfg, jax.random.PRNGKey(5)))
    port = convert_params({n: _np(a) for n, a in jflat.items()}, tcfg, "cpu")
    direct = convert_params({n: np.asarray(a) for n, a in jflat.items()},
                            tcfg, "cpu")
    assert set(port) == set(jflat) == set(TLM.build_defs(tcfg))
    for n, a in jflat.items():
        assert tuple(port[n].shape) == tuple(a.shape), n
        assert str(port[n].dtype) == f"torch.{a.dtype}", n
        np.testing.assert_array_equal(port[n].float().numpy(), _np(a))
        assert torch.equal(direct[n], port[n]), n
    flat = {n: _np(a) for n, a in jflat.items()}
    with pytest.raises(KeyError, match="missing"):
        convert_params({n: a for n, a in flat.items() if n != "head"}, tcfg,
                       "cpu")
    with pytest.raises(KeyError, match="extra"):
        convert_params(dict(flat, **{"layers/se_gate": flat["head"]}), tcfg,
                       "cpu")
    with pytest.raises(ValueError, match="shape"):
        convert_params(dict(flat, embed=flat["head"][:7]), tcfg, "cpu")
    with pytest.raises(KeyError):
        TLM.LM(tcfg, {n: a for n, a in port.items() if n != "embed"})


def test_init_params_styles_and_determinism():
    """Each ParamDef init style and dtype override, drawn layer by layer;
    one generator seed gives one set of parameters."""
    cfg = get_smoke(ARCH)
    defs = TLM.build_defs(cfg)
    assert TP.count_params(defs) == JP.count_params(
        JLM.build_defs(j_get_smoke(ARCH)))
    a = TLM.init_params(cfg, torch.Generator().manual_seed(11))
    b = TLM.init_params(cfg, torch.Generator().manual_seed(11))
    assert all(torch.equal(a[n], b[n]) for n in defs)
    assert a["layers/router"].dtype == torch.float32
    assert a["layers/wq"].dtype == torch.bfloat16
    assert bool((a["layers/mlp_norm"] == 1).all())
    e = a["layers/e_gate"].float()
    assert abs(e.std().item() - cfg.d_model ** -0.5) < 0.01
    assert not torch.equal(e[0], e[1])          # layers drawn separately
    assert abs(a["embed"].float().std().item() - 0.02) < 0.002
    assert TP.unflatten(TP.flatten({"a": {"b": 1}, "c": 2})) == {
        "a": {"b": 1}, "c": 2}


def test_serve_defaults_to_cuda(monkeypatch):
    """Without --device the launcher asks for cuda: it raises where there
    is none and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    monkeypatch.setattr("sys.argv", ["serve", "--arch",
                                     "qwen3-moe-235b-a22b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.generate(get_smoke(ARCH), {}, {"tokens": np.zeros((1, 2))}, 2)
