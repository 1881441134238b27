"""Device-parallel scan scoring: the pair dim sharded over a 1D mesh.

The analog of the reference keeping all <=128 OpenMP threads saturated on
the hot loop (c-core/scan.c:188, thread.c:49-86): each phase-1 call of
scan/scheduler.py PairScorer is ONE SPMD program jitted over a
`jax.sharding.Mesh` — `jax.shard_map` splits the per-pair inputs along
the mesh's `dev` axis, every device runs the same scorer (the Hopper
kernel's FFI call, or the plain engine) on its slice, and the (N,) cost
vectors come back sharded.  Profile tables and the scan's fragment codes
are replicated.  No collectives are needed on the hot path: pairs are
independent, and the merge into deterministic product order happens on
the host exactly as in the single-device scan, so products are
byte-identical for any device count — the reference's
thread-count-invariance contract (python-core/tests/test_scan.py:102-104).
Phase 2 runs on the first device (LRT survivors are few,
c-core/thread.c:119-126).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["MESH_AXIS", "make_mesh", "shard_pairs"]

MESH_AXIS = "dev"


def make_mesh(devices=None) -> Mesh:
    """1D device mesh for pair-sharded scan scoring."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(list(devices)), (MESH_AXIS,))


def shard_pairs(fn, mesh: Mesh):
    """jit(shard_map(fn)) for a scorer call
    fn(tables, tvecs, codes, pidx, starts, lens, xts) -> (alt, null):
    tables, tvecs and codes replicated, the pair arrays and the costs
    sharded along the mesh axis."""
    sh, rep = P(MESH_AXIS), P()
    # check_vma=False: an FFI call's outputs carry no varying-mesh-axes
    # annotation, so shard_map's replication checker cannot see through
    # it; the sharding here is plainly per pair slice.
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(rep, rep, rep, sh, sh, sh, sh),
        out_specs=(sh, sh), check_vma=False))
