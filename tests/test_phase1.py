"""Phase-1 scoring: the pair-batched plain scorer against the oracles, a
NumPy model of the Hopper kernel's arithmetic against viterbi_jax, and the
Python around the kernel (table layout, padding, launch shapes, engine
choice, library build).  The kernel itself runs only on a card: see the
`gpu`-marked test at the end and chip_smoke.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deciphon_tpu.ops import bruteforce
from deciphon_tpu.ops.costs import (CT_DD, CT_DDCUM, TABLE_EXTRA,
                                    build_costs, build_tables)
from deciphon_tpu.ops.engine import scan_pairs
from deciphon_tpu.ops.viterbi_cuda import (MAX_K, launch_shape,
                                           scratch_floats)
from deciphon_tpu.ops.viterbi_jax import viterbi, viterbi_null
from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan.scheduler import (DeviceSeqCodes, PairItem,
                                         PairScorer, bucket_nodes)
from deciphon_tpu.scan.sequence import Sequence, frag_codes_ending
from deciphon_tpu.scan.window import Window
from deciphon_tpu.xtrans import (XT_CC, XT_CT, XT_EB, XT_EC, XT_EJ, XT_ET,
                                 XT_JB, XT_JJ, XT_NB, XT_NN, XT_RR, XT_SB,
                                 XT_SN, xtrans_cost_vector)

INF = np.float32(np.inf)


def reference(costs, codes, L, xt):
    """(null, alt) of one window with the lax.scan engine, unpadded."""
    c = costs
    codes = jnp.asarray(codes)
    alt = viterbi(jnp.asarray(c.core), jnp.asarray(c.match),
                  jnp.asarray(c.null), jnp.asarray(c.background),
                  jnp.asarray(xt), codes, jnp.int32(L))
    nul = viterbi_null(jnp.asarray(c.null), jnp.float32(xt[XT_RR]), codes,
                       jnp.int32(L))
    return np.float32(nul), np.float32(alt)


def random_seqs(rng, lengths):
    return [Sequence.make(i, f"s{i}", "".join(
        "ACGT"[b] for b in rng.integers(0, 4, size=n)))
        for i, n in enumerate(lengths)]


def score_windows(profiles, seqs, spans, mh=True, h3c=False):
    """PairScorer("jax") over explicit (profile, seq, start, stop) spans;
    returns [(item, (null, alt))]."""
    costs = [build_costs(p, mh, h3c) for p in profiles]
    sc = PairScorer(costs, backend="jax")
    dev = sc.make_device_codes(seqs)
    sc.set_device_codes(dev)
    items = [PairItem(p, s, Window(0, a, b), mh, h3c, seq=seqs[s],
                      gstart=dev.gstart(s, a)) for p, s, a, b in spans]
    res = sc.score(items)
    return costs, [(it, res[id(it)]) for it in items]


# -- 1. the batched plain scorer against the oracles -------------------

BRUTE = [  # (seed, K, L, eps, multi_hits, hmmer3_compat)
    (1, 2, 4, 0.1, True, False),
    (2, 2, 6, 0.1, False, False),
    (3, 3, 5, 0.01, True, True),
    (4, 2, 7, 0.5, True, False),
    (5, 3, 7, 0.1, False, True),
]


@pytest.mark.parametrize("seed,K,L,eps,mh,h3c", BRUTE)
def test_plain_scorer_matches_bruteforce(seed, K, L, eps, mh, h3c):
    """Several profiles and windows in one batched call, each equal to
    exhaustive path enumeration (float64) and to per-window viterbi."""
    rng = np.random.default_rng(seed)
    profiles = [sample_profile(seed, K, epsilon=eps),
                sample_profile(seed + 50, K + 1, epsilon=eps)]
    seqs = random_seqs(rng, [L, L + 1])
    spans = [(p, s, 0, seqs[s].size) for p in range(2) for s in range(2)]
    costs, scored = score_windows(profiles, seqs, spans, mh, h3c)
    for it, (nul, alt) in scored:
        c = costs[it.p_idx].with_xtrans(mh, h3c, it.win.length)
        seq = seqs[it.s_idx].symbols
        np.testing.assert_allclose(alt, bruteforce.best_path_cost(c, seq),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(nul, bruteforce.best_null_cost(c, seq),
                                   rtol=2e-5, atol=2e-5)
        assert (nul, alt) == reference(costs[it.p_idx], it.codes,
                                       it.win.length, it.xt)


@pytest.mark.parametrize("mh,h3c", [(True, False), (False, True)])
@pytest.mark.parametrize("ks,lengths", [
    ((1, 40), (50, 300)),
    ((130, 600), (700, 90)),
])
def test_plain_scorer_matches_viterbi(ks, lengths, mh, h3c):
    """Bit-identity with per-window viterbi across buckets, window
    lengths (several power-of-two rungs in one wave) and window offsets."""
    rng = np.random.default_rng(sum(ks))
    profiles = [sample_profile(7 + i, k) for i, k in enumerate(ks)]
    seqs = random_seqs(rng, lengths)
    spans = []
    for p in range(len(profiles)):
        for s, seq in enumerate(seqs):
            a = int(rng.integers(0, seq.size // 2))
            spans.append((p, s, a, seq.size))
    costs, scored = score_windows(profiles, seqs, spans, mh, h3c)
    for it, got in scored:
        assert got == reference(costs[it.p_idx], it.codes, it.win.length,
                                it.xt)


# -- 2. a NumPy model of the kernel's arithmetic -----------------------


def start_codes(end_codes):
    """START-indexed codes: row l, column t-1 = the length-t fragment
    starting at l (the layout of DeviceSeqCodes)."""
    out = np.zeros_like(end_codes)
    n = len(end_codes)
    for t in range(1, 6):
        out[:max(0, n - t + 1), t - 1] = end_codes[t - 1:, t - 1]
    return out


def kernel_model(table, tvec, codes, L, xt, threads, npt):
    """viterbi_cuda.cu step for step: thread i owns nodes [i*npt,
    (i+1)*npt); pending 5-slot M/I rings; the k-1 neighbour in-run or from
    the previous run's last node; the delete chain as a thread-local
    prefix min, a warp scan of the run minima and the minima of the
    preceding warps.  Returns (alt, null) as the kernel computes them."""
    f32 = np.float32
    kn, kw = threads * npt, table.shape[1]
    nw = threads // 32
    BM, MM, MI, MD, IM, II, DM = (tvec[q, :kn] for q in range(7))
    DC = tvec[CT_DDCUM, :kn]
    x = [f32(v) for v in xt]
    pm = np.full((5, kn), INF, f32)
    pi = np.full((5, kn), INF, f32)
    pn, pj, pc, pr = ([INF] * 5 for _ in range(4))

    def shift(v):
        runs = v.reshape(threads, npt)
        out = np.empty_like(runs)
        out[:, 1:] = runs[:, :-1]
        out[1:, 0] = runs[:-1, -1]
        out[0, 0] = INF
        return out.reshape(kn)

    def prefix_min(g):
        local = np.minimum.accumulate(g.reshape(threads, npt), axis=1)
        run_min = local[:, -1].reshape(nw, 32)
        warp_incl = np.minimum.accumulate(run_min, axis=1)
        warp_excl = np.concatenate(
            [np.full((nw, 1), INF, f32), warp_incl[:, :-1]], axis=1)
        warps = np.concatenate([[INF], np.minimum.accumulate(
            warp_incl[:, -1])[:-1]]).astype(f32)
        before = np.minimum(warp_excl, warps[:, None]).reshape(threads)
        return np.minimum(before[:, None], local).reshape(kn)

    def push(slot, l, M, I, Ms, Is, Ds, S, N, B, E, J, C, R):
        for t in range(1, 6):
            u = (slot + t) % 5
            row = table[codes[l, t - 1]]
            nil, bgv, e = row[kw - 2], row[kw - 1], row[:kn]
            for cand in ((B + BM) + e, (Ms + MM) + e, (Is + IM) + e,
                         (Ds + DM) + e):
                pm[u] = np.minimum(pm[u], cand)
            for cand in ((I + II) + bgv, (M + MI) + bgv):
                pi[u] = np.minimum(pi[u], cand)
            pn[u] = min(pn[u], (S + x[XT_SN]) + nil, (N + x[XT_NN]) + nil)
            pj[u] = min(pj[u], (E + x[XT_EJ]) + nil, (J + x[XT_JJ]) + nil)
            pc[u] = min(pc[u], (E + x[XT_EC]) + nil, (C + x[XT_CC]) + nil)
            pr[u] = min(pr[u], (R + x[XT_RR]) + nil)

    T = R = INF
    if L > 0:
        none = np.full((kn,), INF, f32)
        push(0, 0, none, none, none, none, none, f32(0), INF, x[XT_SB],
             INF, INF, INF, -x[XT_RR])
    for l in range(1, L + 1):
        s = l % 5
        M, I = pm[s].copy(), pi[s].copy()
        pm[s] = pi[s] = INF
        N, J, C, R = pn[s], pj[s], pc[s], pr[s]
        pn[s] = pj[s] = pc[s] = pr[s] = INF
        Ms, Is = shift(M), shift(I)
        D = prefix_min((Ms + MD) - DC) + DC
        E = min(M.min(), D.min())
        B = min(N + x[XT_NB], E + x[XT_EB], J + x[XT_JB])
        T = min(E + x[XT_ET], C + x[XT_CT])
        if l < L:
            push(s, l, M, I, Ms, Is, shift(D), INF, N, B, E, J, C, R)
    return T, R


@pytest.mark.parametrize("K,npt", [
    (1, None), (2, None), (31, None), (32, None), (33, None),
    (33, 8), (400, None), (400, 16), (4608, None),
])
def test_kernel_model_bit_identical(K, npt):
    """The kernel's algorithm gives viterbi_jax's costs bit for bit, for
    every node-run size (npt None: the one launch_shape picks)."""
    threads, pick = launch_shape(K)
    if npt is not None:
        threads = -(-K // (32 * npt)) * 32
    else:
        npt = pick
    prof = sample_profile(K, K)
    rng = np.random.default_rng(K)
    L = 60 if K < 1000 else 24
    for mh, h3c in ((True, False), (False, True)):
        costs = build_costs(prof, mh, h3c, window_len=L)
        table, tvec = build_tables(costs, threads * npt)
        seq = rng.integers(0, 4, size=L).astype(np.int8)
        end = frag_codes_ending(seq)
        got = kernel_model(table, tvec, start_codes(end), L, costs.xt,
                           threads, npt)
        nul, alt = reference(costs, end, L, costs.xt)
        assert np.float32(got[0]).tobytes() == alt.tobytes()
        assert np.float32(got[1]).tobytes() == nul.tobytes()


# -- 3. the wrapper: layout, padding, launch shapes ---------------------


def test_build_tables_layout():
    costs = build_costs(sample_profile(3, 37))
    table, tvec = build_tables(costs, 64)
    kw = 64 + TABLE_EXTRA
    assert table.shape == (1364, kw) and tvec.shape == (9, kw)
    np.testing.assert_array_equal(table[:, :37], costs.match)
    assert np.isinf(table[:, 37:kw - 2]).all()
    np.testing.assert_array_equal(table[:, kw - 2], costs.null)
    np.testing.assert_array_equal(table[:, kw - 1], costs.background)
    np.testing.assert_array_equal(tvec[:CT_DDCUM, :37],
                                  costs.core[:CT_DDCUM])
    assert np.isinf(tvec[:CT_DDCUM, 37:]).all()
    # DDCUM equals the unpadded row over K and stays finite, growing
    np.testing.assert_array_equal(tvec[CT_DDCUM, :37], costs.core[CT_DDCUM])
    assert np.isfinite(tvec[CT_DDCUM]).all()
    assert (np.diff(tvec[CT_DDCUM, 36:]) > 1e29).all()
    with pytest.raises(ValueError):
        build_tables(costs, 36)
    assert np.isinf(tvec[CT_DD, 37:]).all()


def test_pad_pairs_score_inf():
    """Length-0 pairs (the padding of every call) score +inf, and padding
    a call leaves the real pairs' costs unchanged."""
    costs = build_costs(sample_profile(5, 20))
    table, tvec = build_tables(costs, 128)
    rng = np.random.default_rng(0)
    dev = DeviceSeqCodes(random_seqs(rng, [90]))
    args = (jnp.asarray(table[None]), jnp.asarray(tvec[None]), dev.dev)
    xt = np.zeros((4, 16), np.float32)
    xt[:, :13] = xtrans_cost_vector(True, False, 90)
    alt, nul = scan_pairs(*args, jnp.zeros(4, jnp.int32),
                          jnp.asarray([0, dev.pad_start, 0, dev.pad_start],
                                      jnp.int32),
                          jnp.asarray([90, 0, 90, 0], jnp.int32),
                          jnp.asarray(xt), lpad=128)
    alt, nul = np.asarray(alt), np.asarray(nul)
    assert np.isinf(alt[[1, 3]]).all() and np.isinf(nul[[1, 3]]).all()
    assert alt[0] == alt[2] and np.isfinite(alt[0])


@pytest.mark.parametrize("K", [1, 31, 32, 33, 128, 129, 1024, 1025, 2048,
                               2049, 4608, 8192, 16383, 16384])
def test_launch_shape(K):
    threads, npt = launch_shape(K)
    assert threads % 32 == 0 and npt in (4, 8, 16)
    assert threads <= (1024 if npt == 16 else 256)
    assert K <= threads * npt < K + 32 * npt  # less than a warp of runs
    # a bucket's width maps back to the same launch shape
    assert launch_shape(bucket_nodes(K, "cuda")) == (threads, npt)
    assert scratch_floats(3, threads, npt) == (
        3 * 10 * threads * npt if npt == 16 else 1)


@pytest.mark.parametrize("K", [0, MAX_K + 1])
def test_launch_shape_rejects(K):
    with pytest.raises(ValueError):
        launch_shape(K)


def test_pair_padding_and_buckets():
    costs = [build_costs(sample_profile(i, k))
             for i, k in enumerate((10, 130, 128, 3000))]
    sc = PairScorer(costs, backend="jax")
    assert [b.kn for b in sc.buckets] == [128, 256, 4096]
    assert [sc._padded(n) for n in (0, 1, 3, 8, 9)] == [1, 1, 4, 8, 16]
    mesh = PairScorer(costs[:1], backend="jax", devices=jax.devices()[:3])
    assert [mesh._padded(n) for n in (1, 3, 5)] == [3, 6, 9]


# -- 4. engine choice and the kernel library ----------------------------


@pytest.mark.parametrize("platform,engine", [("gpu", "cuda"),
                                             ("cpu", "jax")])
def test_default_engine(platform, engine):
    from deciphon_tpu.scan.pipeline import default_engine

    assert default_engine(platform) == engine


def test_default_engine_unknown_platform():
    from deciphon_tpu.scan.pipeline import default_engine

    with pytest.raises(ValueError):
        default_engine("metal")


def test_scanner_engine_follows_platform():
    from deciphon_tpu.scan.pipeline import Scanner

    sc = Scanner([sample_profile(1, 8)])
    assert sc.engine == "jax" and sc.scorer.backend == "jax"


def test_cuda_engine_raises_without_library(monkeypatch):
    """A run that asks for the kernel fails when the library cannot be
    built or loaded: no fallback to the plain engine."""
    from deciphon_tpu.ops import viterbi_cuda
    from deciphon_tpu.scan.pipeline import ScanConfig, Scanner

    def no_nvcc():
        raise viterbi_cuda.KernelUnavailable("nvcc not found")

    monkeypatch.setattr(viterbi_cuda, "_nvcc", no_nvcc)
    monkeypatch.setattr(viterbi_cuda, "_LIB", "/nonexistent/lib.so")
    viterbi_cuda.register.cache_clear()
    try:
        with pytest.raises(viterbi_cuda.KernelUnavailable):
            Scanner([sample_profile(1, 8)], ScanConfig(engine="cuda"))
    finally:
        viterbi_cuda.register.cache_clear()


def test_build_reports_missing_nvcc(monkeypatch, tmp_path):
    from deciphon_tpu.ops import viterbi_cuda

    monkeypatch.setattr(viterbi_cuda, "_LIB", str(tmp_path / "lib.so"))
    monkeypatch.setattr(viterbi_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(viterbi_cuda, "NVCC_DEFAULT",
                        str(tmp_path / "no-nvcc"))
    with pytest.raises(viterbi_cuda.KernelUnavailable, match="nvcc"):
        viterbi_cuda.build()


# -- 5. the scan-resident codes -----------------------------------------


def test_device_start_codes_match_host():
    """The device-computed start-indexed code table equals the host
    per-sequence precompute for every fragment inside the sequence."""
    from deciphon_tpu.scan.scheduler import _start_codes_jit

    rng = np.random.default_rng(3)
    for T in (1, 2, 7, 64, 501):
        bases = rng.integers(0, 4, size=T).astype(np.int8)
        host = start_codes(frag_codes_ending(bases))
        dev = np.asarray(_start_codes_jit()(jnp.asarray(bases)))
        for t in range(1, 6):
            n = max(0, T - (t - 1))
            assert (dev[:n, t - 1] == host[:n, t - 1]).all(), (T, t)


# -- on the card --------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("K", [50, 400, 2000, 4608, 16384])
def test_kernel_matches_plain_on_gpu(gpu_device, K):
    """The CUDA kernel's costs equal the plain engine's on the card."""
    from deciphon_tpu.ops.viterbi_cuda import score_pairs

    rng = np.random.default_rng(K)
    seqs = random_seqs(rng, [3000, 2500, 10, 1])
    costs = build_costs(sample_profile(K, K))
    threads, npt = launch_shape(K)
    table, tvec = build_tables(costs, threads * npt)
    dev = DeviceSeqCodes(seqs, gpu_device)
    n = len(seqs)
    xt = np.zeros((n, 16), np.float32)
    for i, s in enumerate(seqs):
        xt[i, :13] = xtrans_cost_vector(i % 2 == 0, i % 3 == 0, s.size)
    args = [jax.device_put(a, gpu_device) for a in (
        table[None], tvec[None], dev.dev, np.zeros(n, np.int32),
        np.asarray([dev.gstart(i, 0) for i in range(n)], np.int32),
        np.asarray([s.size for s in seqs], np.int32), xt)]
    got = score_pairs(*args, threads=threads, npt=npt)
    want = jax.jit(scan_pairs, static_argnames="lpad")(*args, lpad=4096)
    for g, w in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
