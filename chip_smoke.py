"""Drive the scan's main path once on an NVIDIA GPU, and check what comes out.

    python chip_smoke.py                # one card, every phase below
    python chip_smoke.py --four-cards   # the same scan on four cards vs one

Phases (each prints its own line; any failure exits non-zero):

1. device — the JAX devices must be GPUs; prints the card's name and power
   limit as nvidia-smi reports them.
2. kernel — the phase-1 kernel against the plain engine
   (ops/engine.py scan_scores) on the card, at K in {50, 400, 2000, 4608},
   10 knt windows, every (multi_hits, hmmer3_compat) setting: the costs
   must be bit-identical.
3. scan — a Pfam-shaped database (500 profiles over the geometric K ladder
   50..2000, plus one of K=4608; Pfam-like statistics, see
   EMISSION_SHARPNESS) written with DcpWriter and read back,
   scanned by Scanner with the default ScanConfig over 10 knt reads that
   each carry one planted domain and one 100 knt random read.  Every
   planted domain must be recovered.  A subset of the reads is scanned
   again with the plain engine on the card: the two products.tsv must be
   byte-identical.
4. confirm — the amino-Forward confirmer's log e-values of the scan's
   survivors, on the GPU and on the CPU in the same process: the same
   confirmed hits, e-values within a relative 1e-5 (exp/log differ in the
   last ulps between the two backends).

The last line of standard output is the JSON result.  With --four-cards
only the four-card scan and the one-card scan it is compared with run.
The data is made from --seed; nothing is read from outside the repository.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

N_PROFILES = 500
BIG_K = 4608
PARITY_KS = (50, 400, 2000, 4608)
READ_LEN = 10_000
LONG_READ_LEN = 100_000
# planted 10 knt reads; each carries one domain of a profile near these K
PLANTED_KS = (120, 250, 400, 600)
# the reference README's long read: 23,953 nt with 880 deletions and 711
# insertions against the true sequence (BASELINE.md)
P_DEL, P_INS = 880 / 23953, 711 / 23953
# The database draws each profile's amino model like profile.sample_profile
# (seeded random match distributions) but gives it Pfam-like statistics:
# match distributions sharpened by EMISSION_SHARPNESS (the most likely
# amino of a state gets ~0.2 instead of ~0.1), transitions drawn per
# source state (M: MM MI MD, I: IM II, D: DM DD) around TRANS_MEANS
# instead of normalized over all seven of a node at once (which makes
# every node cost ~log 7 nats), and the standard amino null, which the
# confirmer scores against too.  Then a planted domain scores far above
# the LRT threshold and a random read far below it, as with real profiles.
EMISSION_SHARPNESS = 4.0
TRANS_MEANS = ((0.9, 0.05, 0.05), (0.7, 0.3), (0.7, 0.3))
# the confirmer's e-values need a STATS LOCAL FORWARD calibration, which
# random profiles lack: an assumed (tau, lambda) in HMMER3's usual range
ASSUMED_FORWARD_STATS = (-4.0, 0.69)
EVALUE_RTOL = 1e-5
PLANT_MIN_LRT = 50.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def workload_ks(n: int) -> list[int]:
    """Pfam-shaped core sizes: geometric over [50, 2000] (bench.py)."""
    return [int(round(50 * (2000 / 50) ** (i / (n - 1)))) for i in range(n)]


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    check(r.returncode == 0 and r.stdout.strip(), "nvidia-smi failed")
    return r.stdout.strip()


def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    check(bool(devs) and all(d.platform == "gpu" for d in devs),
          f"no GPU: JAX devices are {devs}")
    check(len(devs) >= n_cards, f"{len(devs)} GPUs, {n_cards} needed")
    print(f"device: {len(devs)} x {devs[0].device_kind}")
    for line in card_line().splitlines():
        print(f"card: {line}")
    return devs


def sample_trans(rng, K: int) -> np.ndarray:
    """(K+1, 7) log transitions (hmmfile.py column order) drawn per source
    state around TRANS_MEANS; node 0 has no D state, node K no MD/DD."""
    t = np.concatenate([rng.dirichlet(np.asarray(m) * 100, size=K + 1)
                        for m in TRANS_MEANS], axis=1)
    t[0, 5:] = (1.0, 0.0)
    t[K, 5:] = (1.0, 0.0)
    t[K, :3] = (t[K, 0] + t[K, 2], t[K, 1], 0.0)
    with np.errstate(divide="ignore"):
        return np.log(t).astype(np.float32)


def build_database(seed: int, tmp: str, ks=None):
    """Press the Pfam-shaped database (or profiles of the given `ks`)
    into a .dcp and read it back.  Returns (profiles, hmms)."""
    from deciphon_tpu.io.dcp import DcpWriter, read_dcp_profiles
    from deciphon_tpu.profile import (ENTRY_DIST_OCCUPANCY, press_profile,
                                      sample_hmm)

    ks = list(ks) if ks is not None else workload_ks(N_PROFILES) + [BIG_K]
    path = os.path.join(tmp, "pfam_shaped.dcp")
    writer = DcpWriter(path, entry_dist=ENTRY_DIST_OCCUPANCY, epsilon=0.1)
    hmms = []
    rng = np.random.default_rng(seed)
    for i, k in enumerate(ks):
        hmm, _ = sample_hmm(seed * 100_000 + i, k)
        lp = EMISSION_SHARPNESS * hmm.match_lprobs.astype(np.float64)
        lp -= np.log(np.exp(lp).sum(axis=1, keepdims=True))
        hmm.match_lprobs = lp.astype(np.float32)
        hmm.trans = sample_trans(rng, k)
        hmm.stats["FORWARD"] = ASSUMED_FORWARD_STATS
        hmms.append(hmm)
        writer.pack_profile(press_profile(hmm, 1, 0.1, ENTRY_DIST_OCCUPANCY))
    writer.close()
    _, profiles = read_dcp_profiles(path)
    check([p.core_size for p in profiles] == ks, "database round trip")
    return profiles, hmms


def consensus_codons(profile, hmm) -> np.ndarray:
    """Codon indices (ACGT order) of the most likely amino of each match
    state, each back-translated with genetic code 1 to its codon that the
    pressed frame emissions favour most over the null."""
    from deciphon_tpu.gencode import get_gencode

    amino = np.argmax(hmm.match_lprobs, axis=1)
    idx = get_gencode(1).amino_idx
    # fragment code of a codon = FRAG_OFFSETS[2] + codon index (frame.py)
    odds = (profile.match_emission[:hmm.length, 20:84]
            - profile.null_emission[None, 20:84])
    odds = np.where(idx[None, :] == amino[:, None], odds, -np.inf)
    return np.argmax(odds, axis=1)


def domain_lrt(profile, dom: str) -> float:
    """LRT of a lone domain under the plain engine on the CPU."""
    import jax
    import jax.numpy as jnp

    from deciphon_tpu.ops.costs import build_costs
    from deciphon_tpu.ops.viterbi_jax import viterbi, viterbi_null
    from deciphon_tpu.scan.sequence import Sequence
    from deciphon_tpu.xtrans import XT_RR, xtrans_cost_vector

    c = build_costs(profile)
    s = Sequence.make(0, "domain", dom)
    xt = xtrans_cost_vector(True, False, s.size)
    with jax.default_device(jax.devices("cpu")[0]):
        codes = jnp.asarray(s.window_codes(0, s.size))
        alt = viterbi(jnp.asarray(c.core), jnp.asarray(c.match),
                      jnp.asarray(c.null), jnp.asarray(c.background),
                      jnp.asarray(xt), codes, jnp.int32(s.size))
        nul = viterbi_null(jnp.asarray(c.null), jnp.float32(xt[XT_RR]),
                           codes, jnp.int32(s.size))
        return 2.0 * (float(nul) - float(alt))


def plant(profile, hmm, rng) -> str:
    """The consensus codons, mutated at the long-read indel rates."""
    from deciphon_tpu.gencode import codon_symbols

    out = []
    for ch in "".join(codon_symbols(c)
                      for c in consensus_codons(profile, hmm)):
        if rng.random() >= P_DEL:
            out.append(ch)
        if rng.random() < P_INS:
            out.append("ACGT"[rng.integers(0, 4)])
    return "".join(out)


def make_reads(profiles, hmms, seed: int, planted_ks=PLANTED_KS,
               read_len: int = READ_LEN, long_read_len: int = LONG_READ_LEN):
    """Planted reads (one domain each, of a profile near each of
    `planted_ks`) and one long random read.  Returns (reads, planted) with planted = [(read idx,
    profile idx, start, stop)]."""
    from deciphon_tpu.scan.sequence import Sequence

    rng = np.random.default_rng(seed)
    ks = np.array([h.length for h in hmms])
    reads, planted = [], []
    for i, k in enumerate(planted_ks):
        # the profile nearest in K whose mutated domain the plain engine
        # (on the CPU) scores at LRT >= PLANT_MIN_LRT: a guard against a
        # random amino model that the LRT cannot see
        for p in np.argsort(np.abs(ks - k), kind="stable")[:8]:
            p = int(p)
            dom = plant(profiles[p], hmms[p], rng)
            if domain_lrt(profiles[p], dom) >= PLANT_MIN_LRT:
                break
        else:
            raise SmokeFailure(f"no detectable domain near K={k}")
        bg = "".join("ACGT"[b] for b in rng.integers(0, 4, size=read_len))
        start = int(rng.integers(read_len // 20,
                                 read_len - len(dom) - read_len // 20))
        seq = bg[:start] + dom + bg[start + len(dom):]
        reads.append(Sequence.make(i, f"planted{i}", seq))
        planted.append((i, p, start, start + len(dom)))
    reads.append(Sequence.make(
        len(reads), "long0",
        "".join("ACGT"[b] for b in rng.integers(0, 4, size=long_read_len))))
    return reads, planted


def read_products(path: str):
    with open(path) as fp:
        fp.readline()
        return [line.rstrip("\n").split("\t") for line in fp]


def phase_kernel(seed: int) -> None:
    """Bit-identity of the kernel with scan_scores on the card."""
    import jax.numpy as jnp

    from deciphon_tpu.ops.costs import build_costs, build_tables
    from deciphon_tpu.ops.engine import scan_scores_jit
    from deciphon_tpu.ops.viterbi_cuda import launch_shape, score_pairs
    from deciphon_tpu.profile import sample_profile
    from deciphon_tpu.scan.scheduler import DeviceSeqCodes
    from deciphon_tpu.scan.sequence import Sequence, frag_codes_ending
    from deciphon_tpu.xtrans import xtrans_cost_vector

    rng = np.random.default_rng(seed + 1)
    flags = [(m, h) for m in (True, False) for h in (False, True)]
    seqs = [Sequence.make(i, f"w{i}", "".join(
        "ACGT"[b] for b in rng.integers(0, 4, size=READ_LEN)))
        for i in range(len(flags))]
    codes = np.stack([frag_codes_ending(s.symbols) for s in seqs])
    xt = np.stack([xtrans_cost_vector(m, h, READ_LEN) for m, h in flags])
    lens = np.full((len(seqs),), READ_LEN, np.int32)
    dev = DeviceSeqCodes(seqs)
    for k in PARITY_KS:
        costs = build_costs(sample_profile(seed * 100_000 + 90_000 + k, k))
        t0 = time.perf_counter()
        nul_r, alt_r = scan_scores_jit(
            jnp.asarray(costs.core[None]), jnp.asarray(costs.match[None]),
            jnp.asarray(costs.null[None]),
            jnp.asarray(costs.background[None]), jnp.asarray(xt),
            jnp.asarray(codes), jnp.asarray(lens))
        nul_r, alt_r = np.asarray(nul_r)[0], np.asarray(alt_r)[0]
        t1 = time.perf_counter()
        threads, npt = launch_shape(k)
        table, tvec = build_tables(costs, threads * npt)
        xts = np.zeros((len(seqs), 16), np.float32)
        xts[:, :13] = xt
        alt_k, nul_k = score_pairs(
            jnp.asarray(table[None]), jnp.asarray(tvec[None]), dev.dev,
            jnp.zeros((len(seqs),), jnp.int32),
            jnp.asarray([dev.gstart(i, 0) for i in range(len(seqs))],
                        jnp.int32),
            jnp.asarray(lens), jnp.asarray(xts), threads=threads, npt=npt)
        alt_k, nul_k = np.asarray(alt_k), np.asarray(nul_k)
        t2 = time.perf_counter()
        check(np.isfinite(alt_r).all() and np.isfinite(nul_r).all(),
              f"K={k}: reference costs not finite")
        same = (np.array_equal(alt_k.view(np.int32), alt_r.view(np.int32))
                and np.array_equal(nul_k.view(np.int32),
                                   nul_r.view(np.int32)))
        print(f"kernel: K={k} threads={threads} nodes/thread={npt} "
              f"windows={len(seqs)}x{READ_LEN} nt bit-identical={same} "
              f"(reference {t1 - t0:.2f} s, kernel {t2 - t1:.2f} s, "
              "compile included)")
        check(same, f"K={k}: kernel costs differ from scan_scores: "
              f"alt {alt_k} vs {alt_r}, null {nul_k} vs {nul_r}")


class RecordingConfirmer:
    """NativeConfirmer that records every call and its result."""

    def __init__(self, hmms):
        from deciphon_tpu.hmmer.forward import NativeConfirmer

        self.inner = NativeConfirmer(hmms)
        self.calls = []

    def confirm(self, p_idx: int, amino_seq: str):
        out = self.inner.confirm(p_idx, amino_seq)
        self.calls.append((p_idx, amino_seq, out[0]))
        return out


def phase_scan(profiles, hmms, reads, planted, tmp: str):
    import jax

    from deciphon_tpu.scan.pipeline import ScanConfig, Scanner

    conf = RecordingConfirmer(hmms)
    scanner = Scanner(profiles, ScanConfig(), confirmer=conf.confirm)
    check(scanner.engine == "cuda", f"default engine is {scanner.engine}")
    t0 = time.perf_counter()
    out = scanner.run(reads, os.path.join(tmp, "scan"))
    wall = time.perf_counter() - t0
    m = scanner.metrics
    rows = read_products(out)
    acc = {i: p.accession for i, p in enumerate(profiles)}
    found = 0
    for ri, p, a, b in planted:
        found += any(
            int(r[0]) == reads[ri].id and r[7] == acc[p]
            and min(b, int(r[2]) + int(r[6])) - max(a, int(r[2]) + int(r[5]))
            >= (b - a) // 2 for r in rows)
    cells = m.cells
    stats = jax.devices()[0].memory_stats() or {}
    p2 = sum(v for k, v in m.walls.items() if k.startswith("phase2"))
    print(f"scan: profiles={len(profiles)} reads={len(reads)} "
          f"nt={sum(r.size for r in reads)} windows={m.windows_scored} "
          f"cells={cells} survivors={m.survivors} products={m.products} "
          f"planted_recovered={found}/{len(planted)} wall_s={wall:.3f} "
          f"phase2_s={p2:.3f} "
          f"peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
          f"bytes_limit={stats.get('bytes_limit')}")
    print(f"scan walls: {json.dumps({k: round(v, 3) for k, v in sorted(m.walls.items())})}")
    check(found == len(planted), "planted domains missed")
    check(m.products > 0 and all(
        math.isfinite(float(r[9])) for r in rows), "products not finite")
    scanner.release()

    # the plain engine on the card over the planted reads: same products
    subset = reads[:2]
    outs = []
    for engine in ("cuda", "jax"):
        sc = Scanner(profiles, ScanConfig(engine=engine),
                     confirmer=conf.inner.confirm)
        t0 = time.perf_counter()
        path = sc.run(subset, os.path.join(tmp, f"subset_{engine}"))
        outs.append((engine, open(path, "rb").read(),
                     time.perf_counter() - t0))
        sc.release()
    same = outs[0][1] == outs[1][1]
    print(f"scan subset: reads={len(subset)} "
          f"products_lines={outs[0][1].count(b'\n') - 1} "
          f"cuda_s={outs[0][2]:.3f} jax_s={outs[1][2]:.3f} "
          f"byte-identical={same}")
    check(same, "default and plain engine products differ")
    return conf.calls


def phase_confirm(hmms, calls) -> None:
    import jax

    from deciphon_tpu.hmmer.forward import NativeConfirmer

    check(len(calls) > 0, "no survivor reached the confirmer")
    cpu = NativeConfirmer(hmms)
    worst = 0.0
    kept_gpu = kept_cpu = 0
    with jax.default_device(jax.devices("cpu")[0]):
        for p, aminos, lev_gpu in calls:
            lev_cpu, _ = cpu.confirm(p, aminos)
            kept_gpu += lev_gpu != 0
            kept_cpu += lev_cpu != 0
            check((lev_gpu != 0) == (lev_cpu != 0),
                  f"profile {p}: confirmed on one backend only")
            if lev_gpu != 0:
                rel = abs(lev_gpu - lev_cpu) / max(abs(lev_cpu), 1e-30)
                worst = max(worst, rel)
    print(f"confirm: calls={len(calls)} confirmed_gpu={kept_gpu} "
          f"confirmed_cpu={kept_cpu} max_rel_diff={worst:.3e} "
          f"rtol={EVALUE_RTOL}")
    check(worst <= EVALUE_RTOL, "log e-values differ beyond the tolerance")
    check(kept_gpu > 0, "no hit confirmed")


def four_cards(profiles, reads, tmp: str) -> None:
    """The scan on four cards (pairs sharded) against one card."""
    import jax

    from deciphon_tpu.scan.pipeline import ScanConfig, Scanner

    outs = []
    for devs in (jax.devices()[:4], jax.devices()[:1]):
        sc = Scanner(profiles, ScanConfig(), devices=devs)
        t0 = time.perf_counter()
        path = sc.run(reads, os.path.join(tmp, f"cards{len(devs)}"))
        outs.append((len(devs), open(path, "rb").read(),
                     time.perf_counter() - t0, sc.metrics))
        sc.release()
    same = outs[0][1] == outs[1][1]
    print(f"four cards: products_lines={outs[0][1].count(b'\n') - 1} "
          f"survivors={outs[0][3].survivors} wall_4={outs[0][2]:.3f} "
          f"wall_1={outs[1][2]:.3f} byte-identical={same}")
    check(same, "four-card products differ from one card's")
    check(outs[0][3].products > 0, "four-card scan wrote no product")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card vs one-card scan")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    n_cards = 4 if args.four_cards else 1
    t_start = time.perf_counter()
    try:
        devs = phase_device(n_cards)
        from deciphon_tpu.utils.jaxcache import enable_compilation_cache

        enable_compilation_cache()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            profiles, hmms = build_database(args.seed, tmp)
            reads, planted = make_reads(profiles, hmms, args.seed)
            print(f"data: profiles={len(profiles)} "
                  f"ks={min(p.core_size for p in profiles)}.."
                  f"{max(p.core_size for p in profiles)} "
                  f"reads={len(reads)} planted={len(planted)} "
                  f"built_s={time.perf_counter() - t0:.1f}")
            if args.four_cards:
                four_cards(profiles, reads, tmp)
            else:
                phase_kernel(args.seed)
                calls = phase_scan(profiles, hmms, reads, planted, tmp)
                phase_confirm(hmms, calls)
    except Exception:  # every phase failure ends the run non-zero
        traceback.print_exc()
        return 1
    print(f"total_s={time.perf_counter() - t_start:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
