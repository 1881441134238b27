"""Min-plus cost layout for the frame Viterbi engines.

Parity: c-core/protein.c:353-394 (protein_setup_viterbi) — all scores are
negated log-probs; transition vectors are laid out per *destination* node
with boundary clamping:

  BM[k] = -BMk[k]                          k = 0..K-1
  MM[k] = -trans[k].MM   (k>=1), INF at 0
  MD[k] = -trans[k].MD   (k>=1), INF at 0
  IM[k] = -trans[k].IM   (k>=1), INF at 0
  DM[k] = -trans[k].DM   (k>=1), INF at 0
  DD[k] = -trans[k].DD   (k>=1), INF at 0
  MI[k] = -trans[k+1].MI (k<=K-2), INF at K-1
  II[k] = -trans[k+1].II (k<=K-2), INF at K-1
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..profile import FrameProfile
from ..xtrans import xtrans_cost_vector

INF = np.float32(np.inf)
NUM_TRANS_VECS = 9  # BM MM MI MD IM II DM DD DDCUM
CT_BM, CT_MM, CT_MI, CT_MD, CT_IM, CT_II, CT_DM, CT_DD = range(8)
# Canonical saturated DD cumulative sum (float64 cumsum cast to f32),
# row 8: the delete-chain prefix-scan offset.  Computed ONCE host-side so
# every engine (lax.scan oracle, score kernel, path kernel) uses
# bit-identical values — an in-trace f32 cumsum rounds differently and
# flips D-backpointer ties between engines.
CT_DDCUM = 8
DD_SAT = 1e30  # saturation for +inf DD entries (padding lanes)


def dd_cum_row(dd: np.ndarray) -> np.ndarray:
    """Saturated float64 cumsum of a DD cost row, cast to f32."""
    ddc = np.zeros(len(dd), np.float64)
    ddc[1:] = np.minimum(dd[1:].astype(np.float64), DD_SAT)
    return np.cumsum(ddc, dtype=np.float64).astype(np.float32)


# Extended-table columns past the scored nodes: two +inf pads, then the
# null and the background emission costs.
TABLE_EXTRA = 4


def build_tables(costs: "ViterbiCosts", kn: int):
    """Device layout of one profile for the phase-1 scorers.

    Returns (table (1364, kn+4) f32, tvec (9, kn+4) f32).  The table holds
    the match costs in columns [0, K), +inf up to the last two columns,
    which carry the null and the background emission costs: one row read
    serves the core and the special states.  tvec is `costs.core` padded
    with +inf, its DDCUM row recomputed over the padded DD row so that it
    stays finite (saturated) past K.  Nodes past K can never win a
    minimum, so scoring all kn+4 columns as nodes (the plain engine) and
    scoring the first kn (the kernel) give the K-node costs bit for bit.
    """
    K = costs.K
    if kn < K:
        raise ValueError(f"table width {kn} < K={K}")
    kw = kn + TABLE_EXTRA
    table = np.full((len(costs.null), kw), INF, np.float32)
    table[:, :K] = costs.match
    table[:, kw - 2] = costs.null
    table[:, kw - 1] = costs.background
    tvec = np.full((NUM_TRANS_VECS, kw), INF, np.float32)
    tvec[:CT_DDCUM, :K] = costs.core[:CT_DDCUM]
    tvec[CT_DDCUM] = dd_cum_row(tvec[CT_DD])
    return table, tvec


@dataclass
class ViterbiCosts:
    """Everything one Viterbi run needs, as dense f32 cost arrays."""

    K: int
    # (8, K) core transition costs, row order BM MM MI MD IM II DM DD
    core: np.ndarray
    # (1364, K) match emission costs (match[c, k] = cost of fragment c at node k)
    match: np.ndarray
    # (1364,) null and background emission costs
    null: np.ndarray
    background: np.ndarray
    # (13,) special transition costs (order: xtrans.xtrans_cost_vector)
    xt: np.ndarray

    def with_xtrans(self, multi_hits: bool, hmmer3_compat: bool,
                    window_len: int) -> "ViterbiCosts":
        """Re-derive the length-conditioned special transitions
        (c-core/work.c:47-51 work_reset)."""
        return ViterbiCosts(
            K=self.K, core=self.core, match=self.match, null=self.null,
            background=self.background,
            xt=xtrans_cost_vector(multi_hits, hmmer3_compat, window_len),
        )


def build_costs(p: FrameProfile, multi_hits: bool = True,
                hmmer3_compat: bool = False, window_len: int = 1) -> ViterbiCosts:
    K = p.core_size
    t = p.trans  # (K+1, 7) log-probs, col order MM MI MD IM II DM DD
    core = np.full((NUM_TRANS_VECS, K), INF, dtype=np.float32)
    core[CT_BM] = -p.BMk
    core[CT_MM, 1:] = -t[1:K, 0]
    core[CT_MI, : K - 1] = -t[1:K, 1]
    core[CT_MD, 1:] = -t[1:K, 2]
    core[CT_IM, 1:] = -t[1:K, 3]
    core[CT_II, : K - 1] = -t[1:K, 4]
    core[CT_DM, 1:] = -t[1:K, 5]
    core[CT_DD, 1:] = -t[1:K, 6]
    core[CT_DDCUM] = dd_cum_row(core[CT_DD])

    return ViterbiCosts(
        K=K,
        core=core,
        match=(-p.match_emission[:K]).T.copy(),  # (1364, K)
        null=(-p.null_emission).astype(np.float32),
        background=(-p.bg_emission).astype(np.float32),
        xt=xtrans_cost_vector(multi_hits, hmmer3_compat, window_len),
    )
