"""Multi-host logic via N local processes (SURVEY.md §4.2 item 4):
jax.distributed with two CPU processes on localhost — the coordinator
wiring, global device view, and a cross-process psum must work exactly
as they would across hosts."""
import os
import subprocess
import sys

import pytest

WORKER = r"""
import os, sys
proc_id = int(sys.argv[1])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
from base_tpu.parallel import distributed
distributed.initialize(
    coordinator_address="127.0.0.1:59731",
    num_processes=2,
    process_id=proc_id,
)
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from base_tpu.parallel.mesh import make_mesh, CHAIN_AXIS

info = distributed.process_info()
assert info["process_count"] == 2, info
assert info["global_devices"] == 4, info

mesh = make_mesh(n_chain_shards=4, n_star_shards=1)

def f(x):
    return jax.lax.psum(x, CHAIN_AXIS)

fn = jax.jit(jax.shard_map(
    f, mesh=mesh, in_specs=P(CHAIN_AXIS), out_specs=P(),
    check_vma=False,
))
x = jnp.arange(4.0)  # globally sharded input
import numpy as np
got = np.asarray(jax.device_get(fn(x)))
assert got.item() == 6.0, got
print(f"proc {proc_id} OK", flush=True)
"""


@pytest.mark.slow
def test_two_process_psum(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i} OK" in out
