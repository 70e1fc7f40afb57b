"""Distributed bundle adjustment over a device mesh.

The reference has no distributed execution of any kind (SURVEY.md §2.3); this
is the design BASELINE.json's config #5 asks for: the map is
partitioned into keyframe blocks, each device owns one block's points and ALL
observations of those points (observations sharded by owning point, cameras
replicated). Per LM iteration the only cross-device traffic is the
psum-reduction of the Schur-reduced camera system — a (K,K,6,6) block + a
(K,6) rhs + a scalar cost — which XLA lowers to all-reduces (NCCL on GPUs). Point
marginalization and back-substitution never leave the owning device.

Multi-host: the same code runs under jax.distributed with a global mesh; the
data plane (which host feeds which observation shard) follows the same
keyframe-block ownership.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from svo_tpu.ba.solver import BAProblem, BAResult, solve_ba

AXIS = "ba_block"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=(AXIS,))


def shard_problem(problem: BAProblem, n_shards: int) -> BAProblem:
    """Repartition a single-device problem into n_shards point blocks.

    HOST-SIDE (NumPy) utility for tests and offline problems — the live
    pipeline path partitions on device by keyframe block instead
    (parallel/global_opt.extract_blocks), with no host round trip.

    Point slots are assigned to shards round-robin by block (slot // block);
    every observation follows its point. Shapes stay static: each shard gets
    P/n point slots and O/n observation slots (rows beyond a shard's capacity
    are dropped — size capacities accordingly).

    Output arrays gain a leading shard axis, ready for device_put with a
    sharded layout (or for vmap-based testing).
    """
    Kc = problem.T_cw.shape[0]
    P_tot = problem.points.shape[0]
    O_tot = problem.obs_cam.shape[0]
    assert P_tot % n_shards == 0, "point slots must divide evenly"
    P_loc = P_tot // n_shards
    O_loc = -(-O_tot // n_shards)

    pnt = np.asarray(problem.obs_pnt)
    cam = np.asarray(problem.obs_cam)
    uv = np.asarray(problem.obs_uv)
    ok = np.asarray(problem.obs_valid)
    pts = np.asarray(problem.points)
    pv = np.asarray(problem.pnt_valid)

    # contiguous blocks: shard s owns slots [s*P_loc, (s+1)*P_loc)
    out = {
        "T_cw": np.tile(np.asarray(problem.T_cw)[None], (n_shards, 1, 1, 1)),
        "cam_valid": np.tile(np.asarray(problem.cam_valid)[None], (n_shards, 1)),
        "points": pts.reshape(n_shards, P_loc, 3),
        "pnt_valid": pv.reshape(n_shards, P_loc),
        "obs_cam": np.zeros((n_shards, O_loc), np.int32),
        "obs_pnt": np.zeros((n_shards, O_loc), np.int32),
        "obs_uv": np.zeros((n_shards, O_loc, 3), np.float32),
        "obs_valid": np.zeros((n_shards, O_loc), bool),
    }
    for s in range(n_shards):
        sel = ok & (pnt // P_loc == s)
        idx = np.nonzero(sel)[0][:O_loc]
        n = len(idx)
        out["obs_cam"][s, :n] = cam[idx]
        out["obs_pnt"][s, :n] = pnt[idx] - s * P_loc
        out["obs_uv"][s, :n] = uv[idx]
        out["obs_valid"][s, :n] = True
    import jax.numpy as jnp

    return BAProblem(**{k: jnp.asarray(v) for k, v in out.items()})


def solve_ba_on_mesh(
    template: BAProblem,
    K_mat,
    baseline_fx,
    mesh: Mesh,
    iterations: int = 10,
    n_fixed: int = 1,
    **kw,
):
    """Build the jitted shard_map BA program for a shard-leading BAProblem.

    Returns fn(sharded_problem) -> BAResult. The problem's leading axis is
    the shard axis (= mesh size); the caller owns data placement — local
    single-process (solve_ba_distributed) and multi-process
    (parallel.multihost.solve_ba_multihost) both drive this same program."""

    def local(problem):
        # strip the leading shard axis (size 1 per device under shard_map)
        problem = jax.tree.map(lambda x: x[0], problem)
        res = solve_ba(
            problem, K_mat, baseline_fx,
            iterations=iterations, n_fixed=n_fixed, axis_name=AXIS, **kw,
        )
        return jax.tree.map(lambda x: x[None], res)

    specs_in = jax.tree.map(lambda _: P(AXIS), template)
    res_struct = jax.eval_shape(
        lambda p: jax.tree.map(lambda x: x[None], solve_ba(
            jax.tree.map(lambda y: y[0], p), K_mat, baseline_fx,
            iterations=iterations, n_fixed=n_fixed, **kw)),
        template,
    )
    specs_out = jax.tree.map(lambda _: P(AXIS), res_struct)
    return jax.jit(
        jax.shard_map(local, mesh=mesh, in_specs=(specs_in,), out_specs=specs_out)
    )


def solve_ba_distributed(
    sharded: BAProblem,
    K_mat,
    baseline_fx,
    mesh: Mesh,
    iterations: int = 10,
    n_fixed: int = 1,
    **kw,
) -> BAResult:
    """Solve a shard_problem()-shaped problem over a single-process mesh.

    sharded arrays have leading axis = mesh size; cameras are replicated
    content-wise but carried per-shard for a uniform pytree."""
    specs_in = jax.tree.map(lambda _: P(AXIS), sharded)
    sharded = jax.device_put(
        sharded, jax.tree.map(lambda s: NamedSharding(mesh, s), specs_in)
    )
    fn = solve_ba_on_mesh(
        sharded, K_mat, baseline_fx, mesh,
        iterations=iterations, n_fixed=n_fixed, **kw,
    )
    return fn(sharded)
