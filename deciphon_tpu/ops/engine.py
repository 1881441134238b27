"""Stacked multi-profile scan engine: the framework's flagship compute step.

Re-architecture of the reference's per-thread protein loop
(c-core/scan.c:188 + thread.c:49-86): instead of one profile per CPU thread,
profiles are padded to a common node count and *stacked* into dense arrays,
so one jitted computation scores a (P profiles x B windows) tile, or N
independent (profile, window) pairs (`scan_pairs`, the plain phase-1
scorer of scan/scheduler.py and the reference of the CUDA kernel).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..frame import TABLE_SIZE
from ..xtrans import XT_RR
from .costs import NUM_TRANS_VECS, ViterbiCosts
from .viterbi_jax import viterbi, viterbi_null

INF = np.float32(np.inf)


@dataclass
class ProfilePack:
    """A stack of P pressed profiles padded to a common K.

    Padding semantics: pad nodes carry +inf transition and emission costs,
    so they can never appear on an optimal path; the min-plus recurrences
    ignore them (validated in tests/test_engine.py against unpadded runs).
    """

    K_pad: int
    core: np.ndarray  # (P, 8, K_pad) f32 costs
    match: np.ndarray  # (P, 1364, K_pad) f32 costs
    null: np.ndarray  # (P, 1364) f32 costs
    background: np.ndarray  # (P, 1364) f32 costs
    core_sizes: np.ndarray  # (P,) int32 true K per profile

    @property
    def num_profiles(self) -> int:
        return self.core.shape[0]

    @classmethod
    def from_costs(cls, costs: list[ViterbiCosts], K_pad: int | None = None,
                   lane_multiple: int = 128) -> "ProfilePack":
        kmax = max(c.K for c in costs)
        if K_pad is None:
            K_pad = ((kmax + lane_multiple - 1) // lane_multiple) * lane_multiple
        assert K_pad >= kmax
        P = len(costs)
        core = np.full((P, NUM_TRANS_VECS, K_pad), INF, np.float32)
        match = np.full((P, TABLE_SIZE, K_pad), INF, np.float32)
        null = np.empty((P, TABLE_SIZE), np.float32)
        background = np.empty((P, TABLE_SIZE), np.float32)
        sizes = np.empty((P,), np.int32)
        from .costs import CT_DD, CT_DDCUM, dd_cum_row

        for i, c in enumerate(costs):
            core[i, :, : c.K] = c.core
            match[i, :, : c.K] = c.match
            null[i] = c.null
            background[i] = c.background
            sizes[i] = c.K
            # DDCUM must stay finite through the padding (an +inf entry
            # turns the prefix-scan's A - DDCUM into NaN): recompute the
            # saturated cumsum over the padded DD row, which continues
            # with DD_SAT steps past K — huge enough that pad lanes never
            # win the chain
            dd_pad = np.full((K_pad,), INF, np.float32)
            dd_pad[: c.K] = c.core[CT_DD]
            core[i, CT_DDCUM] = dd_cum_row(dd_pad)
        return cls(K_pad=K_pad, core=core, match=match, null=null,
                   background=background, core_sizes=sizes)


# ---------------------------------------------------------------------------
# The flagship step: (P profiles) x (B windows) -> null/alt costs.
#
# vmap structure: inner vmap over windows (codes/xt/length vary), outer vmap
# over profiles (cost arrays vary).  XLA fuses the whole tile into one
# program.
# ---------------------------------------------------------------------------

_viterbi_w = jax.vmap(
    functools.partial(viterbi, path=False),
    in_axes=(None, None, None, None, 0, 0, 0),
)
_viterbi_pw = jax.vmap(_viterbi_w, in_axes=(0, 0, 0, 0, None, None, None))

_null_w = jax.vmap(viterbi_null, in_axes=(None, 0, 0, 0))
_null_pw = jax.vmap(_null_w, in_axes=(0, None, None, None))


def scan_scores(core, match, null, background, xt, codes, lengths):
    """Score a (P, B) tile.

    Args:
      core: (P, 8, K) f32; match: (P, 1364, K); null/background: (P, 1364).
      xt: (B, 13) f32 per-window special-transition costs.
      codes: (B, Lpad, 5) int32 fragment codes; lengths: (B,) int32.

    Returns (null_costs, alt_costs), both (P, B) f32.
    """
    alt = _viterbi_pw(core, match, null, background, xt, codes, lengths)
    nul = _null_pw(null, xt[:, XT_RR], codes, lengths)
    return nul, alt


scan_scores_jit = jax.jit(scan_scores)


# ---------------------------------------------------------------------------
# Pair-batched form: N independent (profile, window) pairs per call, the
# plain phase-1 scorer of scan/scheduler.py (and its reference on the GPU).
# The profiles' extended tables (ops/costs.py build_tables) are shared by
# all pairs: each pair's codes are offset into the flattened (P*1364, kw)
# table, so no per-pair copy of a table is made.
# ---------------------------------------------------------------------------

_viterbi_pairs = jax.vmap(
    functools.partial(viterbi, path=False),
    in_axes=(0, None, None, None, 0, 0, 0),
)
_null_pairs = jax.vmap(viterbi_null, in_axes=(None, 0, 0, 0))


def end_codes(codes_all, starts, lpad: int):
    """(N, lpad, 5) END-indexed window codes gathered from the scan's
    START-indexed (T, 5) codes: the length-t fragment ending at position
    l of a window starts at global row start + l - t.  Rows clipped at
    either end are only read where the engine masks them (t > l) or never
    captures them (l > length)."""
    ls = jnp.arange(1, lpad + 1, dtype=jnp.int32)
    ts = jnp.arange(1, 6, dtype=jnp.int32)
    idx = starts[:, None, None] + ls[None, :, None] - ts[None, None, :]
    idx = jnp.clip(idx, 0, codes_all.shape[0] - 1)
    return codes_all[idx, ts - 1]


def scan_pairs(tables, tvecs, codes_all, pidx, starts, lens, xts, *,
               lpad: int):
    """(alt, null) costs of N pairs, each (N,) f32, with the lax.scan engine.

    Same contract as ops/viterbi_cuda.py score_pairs: tables (P, 1364, kw)
    and tvecs (P, 9, kw) from build_tables, codes_all (T, 5) start-indexed,
    pidx/starts/lens (N,) i32, xts (N, 16) f32; lpad >= every length."""
    P, T, kw = tables.shape
    flat = tables.reshape(P * T, kw)
    null = tables[:, :, kw - 2].reshape(-1)
    bg = tables[:, :, kw - 1].reshape(-1)
    codes = end_codes(codes_all, starts, lpad) + (pidx * T)[:, None, None]
    xt = xts[:, :13]
    alt = _viterbi_pairs(tvecs[pidx], flat, null, bg, xt, codes, lens)
    nul = _null_pairs(null, xt[:, XT_RR], codes, lens)
    return alt, nul


def lrt_tile(null_costs, alt_costs):
    """LRT = 2*(null - alt) on min-plus costs (c-core/lrt.h)."""
    return 2.0 * (null_costs - alt_costs)
