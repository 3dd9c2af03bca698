"""True multi-process jax.distributed test (2 CPU processes over localhost).

Validates the multi-host bring-up path (parallel/multihost.py) the way a
pod slice would use it: both processes call initialize_multihost with a
coordinator address, build a global mesh spanning both processes, and run a
collective over a process-sharded global array.
"""
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

WORKER = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
# one device per process (conftest exports 8 virtual devices via XLA_FLAGS,
# which the subprocess would inherit -> 16 global devices)
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from sparta_tpu.parallel.multihost import initialize_multihost
initialize_multihost(coordinator_address=sys.argv[1], num_processes=2,
                     process_id=int(sys.argv[2]))
assert jax.process_count() == 2, jax.process_count()
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()), ("x",))
local = np.full((4, 8), int(sys.argv[2]) + 1.0, np.float32)
glob = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("x")), local, (8, 8))
total = jax.jit(lambda a: a.sum(),
                out_shardings=NamedSharding(mesh, P()))(glob)
print("SUM", float(total), flush=True)
"""


def test_two_process_distributed_init():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"
    src = WORKER.format(repo=str(REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", src, addr, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    # sum over the global array: 4*8*1 + 4*8*2 = 96 on both processes
    for out in outs:
        assert "SUM 96.0" in out, out


WORKER_REORDER_SPMM = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from sparta_tpu.parallel.multihost import initialize_multihost
initialize_multihost(coordinator_address=sys.argv[1], num_processes=2,
                     process_id=int(sys.argv[2]))
pid = int(sys.argv[2])
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from sparta_tpu.definitions import BlockingType
from sparta_tpu.formats import bell_from_csr, random_block_csr
from sparta_tpu.ops import pad_b_for_bell
from sparta_tpu.parallel import shard_bell_rowwise, spmm_rowsharded
from sparta_tpu.parallel.multihost import partitioned_reorder
from sparta_tpu.reorder import BlockingEngine
from sparta_tpu.utils import get_fixed_size_grouping

# identical matrix on both processes (deterministic seed)
m = random_block_csr(64, 64, block=8, block_density=0.3, intra_density=0.6,
                     seed=4, shuffle_rows=True)
mesh = Mesh(np.array(jax.devices()), ("x",))

# THIS process reorders only ITS row range (the per-host flow)
eng = BlockingEngine(tau=0.4, col_block_size=8, row_block_size=8,
                     blocking_algo=BlockingType.iterative_clocked)
g_local = partitioned_reorder(m, eng, n_parts=2, part_id=pid)

# exchange groupings: process-sharded global array -> replicate (allgather)
g_arr = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("x")), g_local.astype(np.int64), (64,))
g_global = np.asarray(
    jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(g_arr))

# blocked SpMM over the 2-process mesh, block-rows sharded
bell = bell_from_csr(m, get_fixed_size_grouping(g_global, 8),
                     block_row_size=8)
dev = shard_bell_rowwise(bell, mesh)
B = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
Bd = jax.device_put(jnp.asarray(pad_b_for_bell(B, bell)),
                    NamedSharding(mesh, P()))
C = spmm_rowsharded(dev, Bd)
chk = float(jax.jit(lambda c: jnp.abs(c).sum(),
                    out_shardings=NamedSharding(mesh, P()))(C))

# local oracle: same grouping, same permuted product
from sparta_tpu.utils import get_permutation
perm = get_permutation(get_fixed_size_grouping(g_global, 8))
C_ref = (m.to_scipy() @ B)[perm]
ref = float(np.abs(C_ref).sum())
assert abs(chk - ref) / ref < 1e-4, (chk, ref)
print("CHECK", chk, flush=True)
"""


def test_two_process_partitioned_reorder_spmm():
    """End-to-end per-host flow: each process reorders its own row range,
    groupings are exchanged with an allgather, and the blocked SpMM runs
    row-sharded over the 2-process mesh — verified against a local oracle."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"
    src = WORKER_REORDER_SPMM.format(repo=str(REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", src, addr, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    assert all("CHECK" in o for o in outs), outs


WORKER_HYBRID = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
# 4 local devices per process -> 8 global: the process x local-device
# analog of a 2-host pod slice
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from sparta_tpu.parallel.multihost import initialize_multihost
initialize_multihost(coordinator_address=sys.argv[1], num_processes=2,
                     process_id=int(sys.argv[2]))
pid = int(sys.argv[2])
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from sparta_tpu.definitions import BlockingType
from sparta_tpu.formats import bell_from_csr, random_block_csr
from sparta_tpu.parallel import pad_block_rows, split_bell_cols
from sparta_tpu.parallel.spmm import spmm_colsplit_reduce_scatter
from sparta_tpu.parallel.multihost import partitioned_reorder
from sparta_tpu.reorder import BlockingEngine
from sparta_tpu.utils import get_fixed_size_grouping, get_permutation

m = random_block_csr(64, 64, block=8, block_density=0.3, intra_density=0.6,
                     seed=4, shuffle_rows=True)
mesh = Mesh(np.array(jax.devices()), ("x",))

# per-host reorder of this process's row range, exchanged via allgather
eng = BlockingEngine(tau=0.4, col_block_size=8, row_block_size=8,
                     blocking_algo=BlockingType.iterative_clocked)
g_local = partitioned_reorder(m, eng, n_parts=2, part_id=pid)
g_arr = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("x")), g_local.astype(np.int64), (64,))
g_global = np.asarray(
    jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(g_arr))

# colsplit + reduce_scatter over the FULL 8-device mesh: each chip holds a
# K-slice; partial products psum_scatter across processes and devices, C lands row-sharded
bell = bell_from_csr(m, get_fixed_size_grouping(g_global, 8),
                     block_row_size=8)
bell_p = pad_block_rows(bell, 8)
ci, nb, v, k_part = split_bell_cols(bell_p, 8)
bw = bell.block_col_size
N = 16
B = np.random.default_rng(0).standard_normal((64, N)).astype(np.float32)
Bp = np.zeros((8 * k_part * bw, N), dtype=np.float32)
Bp[: 64] = B
lo, hi = pid * 4, (pid + 1) * 4

def put(arr):
    shape = arr.shape
    spec = P(*(("x",) + (None,) * (arr.ndim - 1)))
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), arr[lo:hi], shape)

ci_d = put(ci.astype(np.int32))
nb_d = put(nb.astype(np.int32))
v_d = put(v.astype(np.float32))
B_d = put(Bp.reshape(8, k_part * bw, N))
C = spmm_colsplit_reduce_scatter(ci_d, nb_d, v_d, B_d, mesh)
chk = float(jax.jit(lambda c: jnp.abs(c).sum(),
                    out_shardings=NamedSharding(mesh, P()))(C))

perm = get_permutation(get_fixed_size_grouping(g_global, 8))
C_ref = (m.to_scipy() @ B)[perm]
ref = float(np.abs(C_ref).sum())
assert abs(chk - ref) / ref < 1e-4, (chk, ref)
print("CHECK", chk, flush=True)
"""


def test_hybrid_two_process_four_device_colsplit():
    """Process x device hybrid: 2 processes x 4 local devices = 8 global devices.
    Per-host partitioned reorder + grouping allgather, then the colsplit
    SpMM with psum_scatter across the full hybrid mesh, vs a local oracle."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"
    src = WORKER_HYBRID.format(repo=str(REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", src, addr, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    assert all("CHECK" in o for o in outs), outs
