"""The port's train launcher for every family of the registry, on the CPU
at the smoke size: a restart from a checkpoint equals a continuous run
bit for bit, and the launcher's losses follow the JAX package's
``make_train_step`` over the same ``SyntheticLM`` batches from the same
(converted) parameters.

The launcher trains each smoke config as the registry gives it, in
bfloat16 with float32 moments (int8 for MoE).  Both packages round the
same bf16 products in other orders, so the losses differ before any
update: by up to 6.2e-4 relative at step 0 (Zamba2's Mamba2 chunks), and
by no more over the six steps of the five families compared.
``LOSS_RTOL`` = 2e-3 holds them with a margin for the CPU libraries'
thread-dependent sum orders."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.common.types import ParallelConfig as JParallel  # noqa: E402
from repro.common.types import ShapeConfig as JShape  # noqa: E402
from repro.common.types import TrainConfig as JTrain  # noqa: E402
from repro.configs.registry import ARCHS  # noqa: E402
from repro.configs.registry import get_smoke as j_get_smoke  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.parallel import sharding as JSh  # noqa: E402
from repro_torch.ckpt.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs.registry import get_smoke  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402

B, L, STEPS = 2, 32, 6        # L: a multiple of every smoke chunk
LOSS_RTOL = 2e-3
# the restart of every architecture but Qwen3-MoE, which
# tests/test_torch_runtime.py::test_train_launcher_end_to_end covers
RESTART = [a for a in ARCHS if a != "qwen3_moe_235b_a22b"]
# one architecture per family for the comparison with the JAX package
PER_FAMILY = ["qwen1p5_0p5b", "internvl2_1b", "musicgen_large", "rwkv6_7b",
              "zamba2_2p7b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke steps are thousands of tiny ops: on one intra-op thread
    they run several times faster than on every core, and the suite runs
    files on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """launch(arch, steps, name) -> (parameters, last loss, each step's
    loss): the port's launcher at the smoke size on the CPU, checkpoints
    every 2 steps under ``launch.root / name`` (resumed when it holds
    one); each call is made once (the continuous 6-step run of an arch
    serves both tests)."""
    root = tmp_path_factory.mktemp("launch")
    make = TT.make_train_step

    @functools.cache
    def run(arch, steps, name):
        losses = []

        def recording(*args, **kwargs):
            step = make(*args, **kwargs)

            def train_step(params, opt, batch):
                params, opt, metrics = step(params, opt, batch)
                losses.append(float(metrics["loss"]))
                return params, opt, metrics
            return train_step

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TT, "make_train_step", recording)
            params, loss = TT.train(arch, steps=steps, batch=B, seq=L,
                                    smoke=True, ckpt_dir=str(root / name),
                                    ckpt_every=2, device="cpu")
        return params, loss, losses

    run.root = root
    return run


@pytest.mark.parametrize("arch", RESTART)
def test_launcher_restart_bitexact(launch, arch, capsys):
    """4 steps with a checkpoint every 2, then 6 with resume: every
    parameter and the last loss equal a continuous 6-step run's bit for
    bit; the moments are float32 for every family but MoE (int8)."""
    _, loss4, _ = launch(arch, 4, f"{arch}-resumed")
    assert np.isfinite(loss4)
    params, loss, losses = launch(arch, STEPS, f"{arch}-resumed")
    assert "resumed from step 4" in capsys.readouterr().out
    assert len(losses) == STEPS - 4
    cont, loss_c, _ = launch(arch, STEPS, f"{arch}-continuous")
    assert loss == loss_c
    assert set(params) == set(cont)
    assert all(torch.equal(cont[n], params[n]) for n in cont)
    ck = Checkpointer(str(launch.root / f"{arch}-resumed"))
    assert ck.list_steps() == [2, 4, 6]
    _, tree = ck.restore(device="cpu")
    want = torch.int8 if get_smoke(arch).family == "moe" else torch.float32
    assert tree["opt_m"]["m"]["final_norm"].dtype == want
    assert int(tree["opt_meta"]["step"]) == STEPS


def _to_jax(t):
    """A port tensor as the reference's array, bit for bit."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("arch", PER_FAMILY)
def test_launcher_losses_match_jax(launch, arch):
    """The launcher's six losses against the reference's jitted
    ``make_train_step`` on its launcher's plan, started from the port
    launcher's initial parameters (``convert``ed the other way, bit for
    bit) and fed the reference pipeline's batches (equal to the port's,
    ``test_torch_runtime``)."""
    cfg, jcfg = get_smoke(arch), j_get_smoke(arch)
    _, _, losses = launch(arch, STEPS, f"{arch}-continuous")
    init = TLM.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    jparams = JP.unflatten({n: _to_jax(t) for n, t in init.items()})
    plan = JSh.make_plan(jcfg, JShape("custom", "train", L, B),
                         jax.make_mesh((1, 1), ("data", "model")),
                         JParallel(remat="none", microbatch=1))
    assert (plan.microbatch, plan.parallel.moment_dtype) == (1, "float32")
    step = jax.jit(j_train_step(jcfg, plan.parallel,
                                JTrain(warmup_steps=10)))
    opt = JA.init_state(jparams, plan.parallel.moment_dtype)
    data = JSyntheticLM(jcfg, L, B)
    want = []
    for s in range(STEPS):
        jparams, opt, m = step(jparams, opt, {
            k: jnp.asarray(v) for k, v in data.batch(s).items()})
        want.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
