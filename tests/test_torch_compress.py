"""``optim/compress.py::compressed_mean`` (int8 all-gather mean) against
the JAX package's, bit for bit, at 2 and 4 ranks.

The reference runs as ``jax.vmap(partial(compressed_mean, axis_name=
"i"), axis_name="i")`` over the stacked per-rank inputs on one CPU
device.  The port runs in spawned processes on a gloo group (through a
``FileStore`` in the test's temporary directory): each rank quantizes its
own row, gathers, and writes its mean; over the whole group and over a
one-dim ``DeviceMesh``'s named dim."""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.optim import compress as JC  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SHAPE = (6, 33)

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.optim.compress import compressed_mean

rank, n, store, seed, out = sys.argv[1:6]
rank, n, seed = int(rank), int(n), int(seed)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=n)
x = np.load(out + ".in.npy")[rank]
a = compressed_mean(torch.tensor(x), dist.group.WORLD)
mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("pod",))
b = compressed_mean(torch.tensor(x), "pod", mesh)
np.save(out + f".{rank}.npy", np.stack([a.numpy(), b.numpy()]))
dist.barrier()                  # no rank tears down while another talks
dist.destroy_process_group()
"""


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_mean_matches_jax_bit_for_bit(tmp_path, n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n,) + SHAPE) * rng.uniform(
        0.01, 10, (n, SHAPE[0], 1))).astype(np.float32)
    x[0, 0, :5] = 0.0                       # a row with zeros
    out = str(tmp_path / "cm")
    np.save(out + ".in.npy", x)
    want = np.asarray(jax.vmap(functools.partial(
        JC.compressed_mean, axis_name="i"), axis_name="i")(jnp.asarray(x)))
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(n),
                               str(tmp_path / "store"), str(n), out],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    for r in range(n):
        got = np.load(out + f".{r}.npy")
        for g in got:                       # the group, then the mesh dim
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g.view(np.int32),
                                          want[r].view(np.int32))
