"""The port's training runtime: synthetic data and execution plans
against the JAX package's, checkpoints in both directions between the
two packages, bit-exact restart, and the port's train launcher end to end
on the CPU.

Data, plans and checkpoint contents are compared exactly: the data is the
same numpy code, and a checkpoint stores every leaf's bits."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.ckpt.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.common.types import SHAPES as J_SHAPES  # noqa: E402
from repro.common.types import ParallelConfig as JParallel  # noqa: E402
from repro.configs.registry import ARCHS  # noqa: E402
from repro.configs.registry import get as j_get  # noqa: E402
from repro.configs.registry import get_smoke as j_get_smoke  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.parallel import sharding as JSh  # noqa: E402
from repro_torch.ckpt.checkpoint import Checkpointer  # noqa: E402
from repro_torch.common.types import SHAPES, ParallelConfig  # noqa: E402
from repro_torch.common.types import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs.registry import get, get_smoke  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.parallel import sharding as Sh  # noqa: E402

ARCH = "qwen3_moe_235b_a22b"


# ------------------------------------------------------------------ data --

@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batches_match_jax(arch):
    """Every smoke arch's batches (tokens, labels, frames, patches) bit
    for bit, at two steps."""
    cfg = get_smoke(arch)
    for step in (0, 5):
        a = SyntheticLM(cfg, 16, 4, seed=3).batch(step)
        b = JSyntheticLM(j_get_smoke(arch), 16, 4, seed=3).batch(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_data_pipeline_deterministic_and_sharded():
    """The reference's property on the port: ranks concatenate to the
    global batch, and a step is a pure function."""
    cfg = get_smoke("yi_34b")
    a = SyntheticLM(cfg, 16, 8, dp_rank=0, dp_size=2)
    b = SyntheticLM(cfg, 16, 8, dp_rank=1, dp_size=2)
    full = SyntheticLM(cfg, 16, 8)
    np.testing.assert_array_equal(
        np.concatenate([a.batch(7)["tokens"], b.batch(7)["tokens"]]),
        full.batch(7)["tokens"])
    np.testing.assert_array_equal(a.batch(7)["tokens"], a.batch(7)["tokens"])
    assert not np.array_equal(full.batch(7)["tokens"],
                              full.batch(8)["tokens"])


# ----------------------------------------------------------------- plans --

@pytest.mark.parametrize("arch", ARCHS)
def test_make_plan_matches_jax_on_one_device(arch):
    """``make_plan`` at data-parallel size 1 against the reference's on a
    1 x 1 mesh: microbatch and the resolved ParallelConfig, for every
    shape and with a forced microbatch; on the launcher's plan (8 x 512)
    MoE takes int8 moments and every other family float32, one
    microbatch."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    for js, ts in zip(J_SHAPES, SHAPES):
        for kw in (dict(), dict(microbatch=4), dict(moment_dtype="bfloat16")):
            jp = JSh.make_plan(j_get(arch), js, mesh, JParallel(**kw))
            tp = Sh.make_plan(get(arch), ts, None, ParallelConfig(**kw))
            assert tp.microbatch == jp.microbatch, (js.name, kw)
            assert dataclasses.asdict(tp.parallel) == \
                dataclasses.asdict(jp.parallel), (js.name, kw)
            assert tp.describe() == jp.describe()
    plan = Sh.make_plan(get(arch), ShapeConfig("c", "train", 512, 8), None,
                        ParallelConfig(remat="none", microbatch=1))
    want = "int8" if get(arch).family == "moe" else "float32"
    assert (plan.microbatch, plan.parallel.moment_dtype) == (1, want)


# ----------------------------------------------------------- checkpoints --

def test_checkpoint_gc_and_atomicity(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, {"a": torch.ones(4) * s}, blocking=True)
    assert ck.list_steps() == [2, 3]
    # a partial (non-.complete) checkpoint, or a stray .tmp, is invisible
    os.makedirs(tmp_path / "step_00000009")
    os.makedirs(tmp_path / "step_00000010.tmp")
    assert ck.latest_step() == 3
    step, tree = ck.restore(device="cpu")
    assert step == 3 and torch.equal(tree["a"], torch.full((4,), 3.0))
    assert Checkpointer(str(tmp_path / "empty")).restore(device="cpu") == \
        (None, None)
    with pytest.raises(TypeError):
        ck.save(4, [torch.ones(1)])


def test_checkpoint_save_snapshots_before_returning(tmp_path):
    """The background writer stores the values at ``save`` time, though
    the caller updates its tensors in place right after."""
    ck = Checkpointer(str(tmp_path))
    t = torch.arange(6, dtype=torch.float32)
    ck.save(1, {"t": t})
    t.add_(100)
    ck.wait()
    _, tree = ck.restore(device="cpu")
    assert torch.equal(tree["t"], torch.arange(6, dtype=torch.float32))


def _tree_np(rng):
    """One leaf of each dtype the trainer stores."""
    bf = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    return {"params": {"w": np.asarray(bf),
                       "layers": {"router": rng.standard_normal(
                           (2, 4, 3)).astype(np.float32)}},
            "opt_m": {"m": {"w": rng.integers(-127, 128, (3, 5)).astype(
                np.int8)}},
            "opt_meta": {"step": np.asarray(17, np.int32)}}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(a)


def test_jax_checkpoint_restored_by_port(tmp_path):
    rng = np.random.default_rng(0)
    src = _tree_np(rng)
    JCheckpointer(str(tmp_path)).save(5, jax.tree.map(jnp.asarray, src),
                                      blocking=True)
    step, tree = Checkpointer(str(tmp_path)).restore(device="cpu")
    assert step == 5
    want = {n: _to_torch(a) for n, a in TP.flatten(src).items()}
    got = TP.flatten(tree)
    assert set(got) == set(want)
    for n, t in want.items():
        assert got[n].dtype == t.dtype and torch.equal(got[n], t), n


def test_port_checkpoint_restored_by_jax(tmp_path):
    rng = np.random.default_rng(1)
    src = {n: _to_torch(a) for n, a in TP.flatten(_tree_np(rng)).items()}
    ck = Checkpointer(str(tmp_path))
    ck.save(7, TP.unflatten(src))
    ck.wait()
    meta = json.load(open(tmp_path / "step_00000007" / "manifest.json"))
    assert meta["leaves"]["params/w"]["dtype"] == "bfloat16"
    step, tree = JCheckpointer(str(tmp_path)).restore()
    assert step == 7
    got = TP.flatten(tree)
    assert set(got) == set(src)
    for n, t in src.items():
        a = np.asarray(got[n])
        assert a.dtype.name == str(t.dtype).split(".")[1], n
        assert torch.equal(_to_torch(a), t), n


def test_checkpoint_restart_bitexact(tmp_path):
    """Train 6 steps; vs train 3 + checkpoint + restore + 3: identical
    parameters and moments (int8), bit for bit, on the CPU."""
    cfg = get_smoke(ARCH)
    step_fn = make_train_step(cfg, ParallelConfig(
        remat="none", microbatch=1, moment_dtype="int8"),
        TrainConfig(warmup_steps=2))
    data = SyntheticLM(cfg, 32, 4)

    def fresh():
        p = TLM.init_params(cfg, torch.Generator().manual_seed(0))
        return p, TA.init_state(p, "int8")

    p, o = fresh()
    for s in range(6):
        p, o, _ = step_fn(p, o, data.batch(s))
    ref_p, ref_o = p, o

    p, o = fresh()
    ck = Checkpointer(str(tmp_path))
    for s in range(3):
        p, o, _ = step_fn(p, o, data.batch(s))
    ck.save(3, dict(params=p, m=o.m, ms=o.m_scale, v=o.v, vs=o.v_scale,
                    step=o.step), blocking=True)
    del p, o
    step_r, tree = ck.restore(device="cpu")
    assert step_r == 3
    p = TP.flatten(tree["params"])
    o = TA.AdamWState(tree["step"], *(TP.flatten(tree[k])
                                      for k in ("m", "ms", "v", "vs")))
    for s in range(3, 6):
        p, o, _ = step_fn(p, o, data.batch(s))
    assert all(torch.equal(ref_p[n], p[n]) for n in ref_p)
    assert all(torch.equal(ref_o.m[n], o.m[n]) and
               torch.equal(ref_o.v_scale[n], o.v_scale[n]) for n in ref_p)
    assert int(o.step) == 6


# -------------------------------------------------------------- launcher --

def test_train_launcher_end_to_end(tmp_path, capsys):
    """4 steps with a checkpoint every 2, then 6 with resume: the final
    parameters equal a continuous 6-step run bit for bit."""
    kw = dict(batch=2, seq=32, smoke=True, ckpt_every=2, device="cpu")
    params, loss = TT.train("qwen3-moe-235b-a22b", steps=4,
                            ckpt_dir=str(tmp_path / "a"), **kw)
    assert np.isfinite(loss)
    assert Checkpointer(str(tmp_path / "a")).list_steps() == [2, 4]
    params, loss2 = TT.train("qwen3-moe-235b-a22b", steps=6,
                             ckpt_dir=str(tmp_path / "a"), **kw)
    assert np.isfinite(loss2)
    assert "resumed from step 4" in capsys.readouterr().out
    cont, loss3 = TT.train("qwen3-moe-235b-a22b", steps=6,
                           ckpt_dir=str(tmp_path / "b"), **kw)
    assert loss3 == loss2
    assert all(torch.equal(cont[n], params[n]) for n in cont)
    assert params["layers/wq"].dtype == torch.bfloat16
    _, tree = Checkpointer(str(tmp_path / "a")).restore(device="cpu")
    assert tree["opt_m"]["m"]["layers"]["wq"].dtype == torch.int8
    assert int(tree["opt_meta"]["step"]) == 6


def test_train_launcher_stops_on_a_non_finite_loss(tmp_path, monkeypatch):
    def nan_step(*args, **kwargs):
        def step(params, opt, batch):
            return params, opt, {"loss": torch.tensor(float("nan"))}
        return step
    monkeypatch.setattr(TT, "make_train_step", nan_step)
    with pytest.raises(FloatingPointError, match="step 0"):
        TT.train("qwen3-moe-235b-a22b", steps=2, batch=2, seq=32,
                 smoke=True, ckpt_dir=str(tmp_path), device="cpu")


def test_train_defaults_to_cuda(monkeypatch, tmp_path):
    """Without --device the launcher asks for cuda: it raises where there
    is none and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "qwen3-moe-235b-a22b", "--smoke", "--steps", "1",
        "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Checkpointer(str(tmp_path)).restore()
