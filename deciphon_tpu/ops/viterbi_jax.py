"""Frame Viterbi in pure JAX (lax.scan) — the single-device reference engine.

Implements the min-plus recurrence of the reference's striped SIMD kernel
(c-core/viterbi.c:451-600) in its *logical* (unstriped) form:

  position l = 1..L, durations t = 1..5, fragment code c(l,t) = seq[l-t, l):

    N_l = min_t min(S_{l-t}+SN, N_{l-t}+NN) + null[c]
    J_l = min_t min(E_{l-t}+EJ, J_{l-t}+JJ) + null[c]
    C_l = min_t min(E_{l-t}+EC, C_{l-t}+CC) + null[c]
    M_l[k] = min_t [min(B_{l-t}+BM[k], M_{l-t}[k-1]+MM[k],
                        I_{l-t}[k-1]+IM[k], D_{l-t}[k-1]+DM[k]) + match[c,k]]
    I_l[k] = min_t [min(I_{l-t}[k]+II[k], M_{l-t}[k]+MI[k]) + bg[c]]
    D_l[k] = min(M_l[k-1]+MD[k], D_l[k-1]+DD[k])          (mute chain over k)
    E_l = min_k min(M_l[k], D_l[k])
    B_l = min(N_l+NB, E_l+EB, J_l+JB)   (+ SB at l=0 init)
    T_l = min(E_l+ET, C_l+CT)

The reference's data-dependent "lazy-DD" fix-up loop (viterbi.c:561-580) is
replaced by a closed-form min-plus prefix scan: with S[k] = Σ_{j<=k} DD[j]
and A[k] = M_l[k-1]+MD[k],  D_l[k] = min_{j<=k}(A[j]-S[j]) + S[k] — the same
fixpoint, computed in O(K) work / O(log K) depth (no data-dependent
control flow).

Path mode additionally emits the bit-packed backpointer trellis in the
reference's exact encoding (c-core/state.h:28-39, trellis.h trellis_set),
so the host-side traceback (ops/traceback.py) mirrors trellis_unzip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..xtrans import (XT_CC, XT_CT, XT_EB, XT_EC, XT_EJ, XT_ET, XT_JB, XT_JJ,
                      XT_NB, XT_NN, XT_RR, XT_SB, XT_SN)
from .costs import (CT_BM, CT_DDCUM, CT_DM, CT_II, CT_IM, CT_MD, CT_MI,
                    CT_MM)

INF = jnp.float32(jnp.inf)


def _shift_k(x):
    """Node shift: out[k] = x[k-1], out[0] = +inf (viterbi.c `shift`)."""
    return jnp.concatenate([jnp.full(x.shape[:-1] + (1,), INF, x.dtype),
                            x[..., :-1]], axis=-1)


def _dd_chain(A, DD_cum):
    """D[k] = min(A[k], D[k-1]+DD[k]) via min-plus prefix scan."""
    G = A - DD_cum
    P = jax.lax.cummin(G, axis=G.ndim - 1)
    return P + DD_cum


@functools.partial(jax.jit, static_argnames=("path",))
def viterbi(core, match, null, background, xt, codes, length, path=False):
    """Run the frame Viterbi on one window.

    Args:
      core: (8, K) f32 core transition costs (ops/costs.py layout).
      match: (1364, K) f32 match emission costs.
      null, background: (1364,) f32 emission costs.
      xt: (13,) f32 special transition costs (xtrans_cost_vector order).
      codes: (Lpad, 5) int32; codes[l-1, t-1] = fragment code for the
        fragment of length t ending at position l (garbage where t > l or
        l > length; those entries are masked / ignored).
      length: scalar int32, actual window length (<= Lpad).
      path: static; if True also return the packed trellis.

    Returns:
      score mode: final T cost (f32 scalar).
      path mode: (T cost, xnodes (Lpad+1,) uint32, nodes (Lpad+1, K) uint16).
    """
    K = core.shape[1]
    Lpad = codes.shape[0]

    BM, MM, MI, MD = core[CT_BM], core[CT_MM], core[CT_MI], core[CT_MD]
    IM, II, DM = core[CT_IM], core[CT_II], core[CT_DM]

    # Canonical host-computed saturated DD cumsum (ops/costs.py
    # dd_cum_row): shared bit-identically with the CUDA kernel so
    # D-backpointer tie-breaks agree across engines.
    DD_cum = core[CT_DDCUM]

    ts = jnp.arange(1, 6, dtype=jnp.int32)  # durations

    def step(carry, inputs):
        (Mr, Ir, Dr, Nr, Br, Jr, Er, Cr, T_final) = carry
        l, codes_l = inputs  # l: 1-based position; codes_l: (5,) int32

        valid = ts <= l  # (5,) duration validity
        nil = jnp.where(valid, null[codes_l], INF)  # (5,)
        bg = jnp.where(valid, background[codes_l], INF)  # (5,)
        ma = jnp.where(valid[:, None], match[codes_l], INF)  # (5, K)

        # S_{l-t} is finite (0) only when l-t == 0.
        S_prev = jnp.where(ts == l, 0.0, INF)  # (5,)

        # ---- special states fed by older positions ----
        # candidates in reference scan order: t desc outer, listed-row inner
        # (viterbi.c:485-502; facc keeps the first minimum on ties).
        def order2(c0, c1):
            return jnp.stack([c0, c1])[:, ::-1].T.reshape(-1)  # (10,)

        n_cands = order2(S_prev + xt[XT_SN] + nil, Nr + xt[XT_NN] + nil)
        j_cands = order2(Er + xt[XT_EJ] + nil, Jr + xt[XT_JJ] + nil)
        c_cands = order2(Er + xt[XT_EC] + nil, Cr + xt[XT_CC] + nil)
        N_l = jnp.min(n_cands)
        J_l = jnp.min(j_cands)
        C_l = jnp.min(c_cands)

        # ---- core M / I ----
        Mprev = jax.vmap(_shift_k)(Mr)  # (5, K): M_{l-t}[k-1]
        Iprev = jax.vmap(_shift_k)(Ir)
        Dprev = jax.vmap(_shift_k)(Dr)
        m_cands = jnp.stack([
            Br[:, None] + BM[None, :],
            Mprev + MM[None, :],
            Iprev + IM[None, :],
            Dprev + DM[None, :],
        ]) + ma[None]  # (4, 5, K)
        # reference order: t desc outer, (BM, MM, IM, DM) inner
        m_ord = m_cands[:, ::-1].transpose(1, 0, 2).reshape(20, K)
        M_l = jnp.min(m_ord, axis=0)

        i_cands = jnp.stack([
            Ir + II[None, :],
            Mr + MI[None, :],
        ]) + bg[None, :, None]  # (2, 5, K); ref order II then MI per t
        i_ord = i_cands[:, ::-1].transpose(1, 0, 2).reshape(10, K)
        I_l = jnp.min(i_ord, axis=0)

        # ---- D chain (mute, same position) ----
        A = _shift_k(M_l) + MD  # (K,)
        D_l = _dd_chain(A, DD_cum)

        # ---- E / B / T (mute, same position) ----
        E_l = jnp.minimum(jnp.min(M_l), jnp.min(D_l))

        b_cands = jnp.stack([N_l + xt[XT_NB], E_l + xt[XT_EB], J_l + xt[XT_JB]])
        B_l = jnp.min(b_cands)  # SB only reachable at l=0 (handled in init)

        t_cands = jnp.stack([E_l + xt[XT_ET], C_l + xt[XT_CT]])
        T_l = jnp.min(t_cands)

        T_final = jnp.where(l == length, T_l, T_final)

        # ---- pack trellis fields (reference encodings) ----
        if path:
            m_idx = jnp.argmin(m_ord, axis=0)  # (K,)
            m_choice = m_idx % 4  # 0 BM, 1 MM, 2 IM, 3 DM
            m_t = 5 - m_idx // 4
            i_idx = jnp.argmin(i_ord, axis=0)
            i_choice = i_idx % 2  # 0 II, 1 MI
            i_t = 5 - i_idx // 2
            d_is_dd = (D_l < A)  # strict: MD wins ties (facc keeps first)
            e_cands = jnp.stack([M_l, D_l], axis=-1).reshape(2 * K)
            e_idx = jnp.argmin(e_cands)  # = 2k + isD
            n_idx = jnp.argmin(n_cands)
            j_idx = jnp.argmin(j_cands)
            c_idx = jnp.argmin(c_cands)
            b_idx = jnp.argmin(b_cands)
            t_idx = jnp.argmin(t_cands)
            # xnode: N(4b@0) B(2b@4) E(15b@6) C(4b@21) T(1b@25) J(4b@26)
            n_field = (n_idx % 2) * 5 + (5 - n_idx // 2 - 1)
            b_field = b_idx + 1  # 0=SB 1=NB 2=EB 3=JB; SB unreachable l>0
            e_field = e_idx
            c_field = (c_idx % 2) * 5 + (5 - c_idx // 2 - 1)
            t_field = t_idx
            j_field = (j_idx % 2) * 5 + (5 - j_idx // 2 - 1)
            xnode = (n_field.astype(jnp.uint32)
                     | (b_field.astype(jnp.uint32) << 4)
                     | (e_field.astype(jnp.uint32) << 6)
                     | (c_field.astype(jnp.uint32) << 21)
                     | (t_field.astype(jnp.uint32) << 25)
                     | (j_field.astype(jnp.uint32) << 26))
            # node: M(5b@0) D(1b@5) I(4b@6)
            m_field = m_choice * 5 + (m_t - 1)
            d_field = d_is_dd.astype(jnp.uint16)
            i_field = (1 - i_choice) * 5 + (i_t - 1)  # MI base 0, II base 5
            node = (m_field.astype(jnp.uint16)
                    | (d_field << 5)
                    | (i_field.astype(jnp.uint16) << 6))
            out = (xnode, node)
        else:
            out = ()

        # ---- rotate rings ----
        def push(ring, new):
            return jnp.concatenate([new[None], ring[:-1]], axis=0)

        carry = (push(Mr, M_l), push(Ir, I_l), push(Dr, D_l),
                 push(Nr, N_l), push(Br, B_l), push(Jr, J_l),
                 push(Er, E_l), push(Cr, C_l), T_final)
        return carry, out

    Mr0 = jnp.full((5, K), INF)
    Nr0 = jnp.full((5,), INF)
    Br0 = Nr0.at[0].set(xt[XT_SB])  # B_0 = SB (viterbi.c:473)
    carry0 = (Mr0, Mr0, Mr0, Nr0, Br0, Nr0, Nr0, Nr0, INF)

    ls = jnp.arange(1, Lpad + 1, dtype=jnp.int32)
    carry, outs = jax.lax.scan(step, carry0, (ls, codes))
    T_final = carry[8]

    if path:
        xnodes = jnp.concatenate([jnp.zeros((1,), jnp.uint32), outs[0]])
        nodes = jnp.concatenate([jnp.zeros((1, K), jnp.uint16), outs[1]])
        return T_final, xnodes, nodes
    return T_final


@jax.jit
def viterbi_null(null, RR, codes, length):
    """Scalar null-model DP (c-core/viterbi.c:696-719).

    null: (1364,) f32 emission costs; RR: f32 cost (-log p_RR);
    codes: (Lpad, 5) int32; length: actual length.
    Returns the null path cost.
    """
    ts = jnp.arange(1, 6, dtype=jnp.int32)

    def step(carry, inputs):
        Rr, R_final = carry  # Rr: (5,) ring, Rr[j] = R_{l-1-j}
        l, codes_l = inputs
        valid = ts <= l
        nil = jnp.where(valid, null[codes_l], INF)
        R_l = jnp.min((Rr + RR) + nil)
        R_final = jnp.where(l == length, R_l, R_final)
        Rr = jnp.concatenate([R_l[None], Rr[:-1]])
        return (Rr, R_final), ()

    Rr0 = jnp.full((5,), INF).at[0].set(-RR)  # R_0 = -RR (viterbi.c:703)
    Lpad = codes.shape[0]
    ls = jnp.arange(1, Lpad + 1, dtype=jnp.int32)
    (Rr, R_final), _ = jax.lax.scan(step, (Rr0, INF), (ls, codes))
    return R_final


# Batched variants: one profile, many windows.
viterbi_batch = jax.jit(
    jax.vmap(
        functools.partial(viterbi, path=False),
        in_axes=(None, None, None, None, 0, 0, 0),
    )
)
viterbi_null_batch = jax.jit(
    jax.vmap(viterbi_null, in_axes=(None, None, 0, 0))
)
# Path mode batched across survivors of one profile (phase-2 of the scan
# pipeline): returns (scores (B,), xnodes (B, Lpad+1), nodes (B, Lpad+1, K)).
viterbi_path_batch = jax.jit(
    jax.vmap(
        functools.partial(viterbi, path=True),
        in_axes=(None, None, None, None, 0, 0, 0),
    )
)
