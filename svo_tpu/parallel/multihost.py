"""Multi-process (multi-host) execution layer.

The reference is a single process with 4 threads (SURVEY.md §2.3); this
framework scales across hosts with `jax.distributed.initialize` plus a
GLOBAL device mesh: every process contributes its local devices, jit'd
programs are identical on every process, and XLA lowers the cross-block
collectives (the psum of the Schur-reduced camera system in
svo_tpu/parallel/ba.py) to NCCL all-reduces on GPUs.

Host-side data plane: each process feeds only the shards its own devices own
(`jax.make_array_from_process_local_data`) — for VO that means each host
reads its own keyframe-block's observations, nothing is gathered to one
host. This module is backend-agnostic: the 2-process localhost CPU test
(tests/test_multihost.py) runs the exact same code path a multi-GPU
cluster would, minus hardware.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from svo_tpu.ba.solver import BAProblem, BAResult
from svo_tpu.parallel.ba import AXIS, solve_ba_on_mesh


def init(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_cpu_devices: int = 0,
) -> None:
    """Initialize the multi-process runtime.

    Call ONCE per process before any backend use. With local_cpu_devices > 0
    the process is forced onto the CPU backend with that many virtual
    devices (the localhost test topology: N processes x D virtual CPU
    devices = one global N*D mesh). On GPU hosts leave it 0 — the CUDA
    plugin provides the local devices. The platform override must happen
    before the backend initializes (tests/conftest.py has the same
    constraint).
    """
    if local_cpu_devices:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", local_cpu_devices)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = AXIS) -> Mesh:
    """1-D mesh over ALL devices of ALL processes, in process order."""
    return Mesh(np.array(jax.devices()), axis_names=(axis,))


def put_sharded(tree, mesh: Mesh):
    """Build global arrays from process-local shard data.

    Every leaf has a leading axis of length mesh.size; this process supplies
    only the rows owned by its addressable devices (contiguous in process
    order, since global_mesh lists devices process-major). Accepts either
    the full global array (rows for other processes are ignored) or exactly
    the local rows.
    """
    n_total = mesh.size
    n_local = len([d for d in mesh.devices.flat if d.process_index == jax.process_index()])
    start = jax.process_index() * n_local

    def put(x):
        x = np.asarray(x)
        if x.shape[0] == n_total:
            local = x[start : start + n_local]
        elif x.shape[0] == n_local:
            local = x
        else:
            raise ValueError(
                f"leading axis {x.shape[0]} is neither global ({n_total}) "
                f"nor local ({n_local})"
            )
        sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
        return jax.make_array_from_process_local_data(sharding, local)

    return jax.tree.map(put, tree)


def solve_ba_multihost(
    sharded_local: BAProblem,
    K_mat,
    baseline_fx,
    mesh: Mesh | None = None,
    iterations: int = 10,
    n_fixed: int = 1,
    **kw,
) -> BAResult:
    """Distributed BA across all processes' devices.

    sharded_local: a shard_problem()-shaped BAProblem whose leading axis is
    either the GLOBAL shard count (mesh.size; other processes' rows ignored)
    or this process's LOCAL shard count. Identical semantics to
    parallel.ba.solve_ba_distributed, but the data plane is process-local.
    """
    mesh = mesh or global_mesh()
    global_problem = put_sharded(sharded_local, mesh)
    fn = solve_ba_on_mesh(
        global_problem, K_mat, baseline_fx, mesh,
        iterations=iterations, n_fixed=n_fixed, **kw,
    )
    return fn(global_problem)
