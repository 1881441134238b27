"""The scan pipeline: batched two-phase Viterbi over (profile, window) pairs.

Reference call stack being re-architected (SURVEY.md §3.2): the per-thread
protein x sequence x window loop of c-core/thread.c:49-208 becomes

  phase 1 (device, batched): null + alt frame Viterbi for every in-flight
    (profile, window) pair at once — the Hopper kernel on a GPU, the plain
    lax.scan engine on the CPU — via the batch scheduler
    (scan/scheduler.py), then the LRT filter (thread.c:114-121);
  phase 2 (device per survivor group + host): path Viterbi -> packed
    trellis -> device traceback -> hit segmentation -> ML codon/amino
    decode -> product line (thread.c:126-207).

Windows of one (profile, sequence) pair advance serially with last-hit
feedback (exact window.c semantics); batching happens across the full
profiles x sequences cross product, so device batches stay large while
per-pair semantics stay exact.  Product lines are emitted in deterministic
(profile, sequence, window) order regardless of batch composition — the
reference's thread-count-invariance contract
(python-core/tests/test_scan.py:102-104).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

import functools

from .. import states as st
from ..ops.costs import ViterbiCosts, build_costs
from ..profile import FrameProfile
from .decoder import Decoder
from .product import ProductLine, ProductWriter
from .scheduler import PairItem, PairScorer
from .sequence import Sequence
from .window import WindowCursor

HMMER_MAX_AMINO = 100000  # c-core/thread.c:184

_state_name_cached = functools.lru_cache(maxsize=1 << 16)(st.state_name)


def lrt(null_cost: float, alt_cost: float) -> float:
    """LRT from min-plus costs (lrt.h: -2(null_loglik - alt_loglik))."""
    return 2.0 * (float(null_cost) - float(alt_cost))


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_len(n: int) -> int:
    """Bucket window lengths to limit path-pass recompilation."""
    if n <= 256:
        return _round_up(max(n, 1), 64)
    return 1 << math.ceil(math.log2(n))


@dataclass
class ScanConfig:
    multi_hits: bool = True
    hmmer3_compat: bool = False
    max_pairs: int = 256  # pairs in flight per scoring round
    # "cuda" (the Hopper kernel) | "jax" (plain XLA) | "native" (host
    # C++); None takes default_engine() of the first device's platform
    engine: str | None = None
    # Thread count for the host ("native") engine only; 0 = all cores.
    # Device engines run one jitted program — the flag is meaningless
    # there (the reference's NUM_THREADS OpenMP fan-out,
    # c-core/scan.c:137-160, maps to the kernel's batch dim instead).
    num_threads: int = 0
    # Window-chain speculation depth cap: windows generated ahead of the
    # last-hit feedback per (profile, sequence) cursor.  Depth starts at
    # the cursor's expected window count, drops to 1 after a hit rewind,
    # and doubles back while hit-free — hit-dense cursors degrade to the
    # serial walk with zero waste, hit-free cursors score whole chains
    # per wave.
    spec_depth: int = 64


def default_engine(platform: str) -> str:
    """The phase-1 engine for a JAX platform: the Hopper kernel on a GPU,
    the plain XLA engine on the CPU."""
    if platform == "gpu":
        return "cuda"
    if platform == "cpu":
        return "jax"
    raise ValueError(f"no scan engine for platform {platform!r}")


class Scanner:
    """Scans sequence batches against a list of pressed profiles.

    `confirmer`, if given, is called as confirmer(protein_idx, amino_seq)
    and must return (logevalue, h3r_blob|None) — the hmmpgmd confirmation
    stage (c-core/hmmer.c).  Without it, every LRT hit is kept and
    reported with evalue 1 (log 0).

    `devices` (default: the first JAX device) are the devices phase 1 runs
    on; with several, each scoring call's pairs are sharded over them.
    """

    def __init__(self, profiles: list[FrameProfile], config: ScanConfig = None,
                 confirmer=None, abc_name: str = "dna", scorer=None,
                 devices=None):
        import jax

        self.profiles = profiles
        self.config = config or ScanConfig()
        self.confirmer = confirmer
        self.abc_name = abc_name
        self.devices = list(devices) if devices else jax.devices()[:1]
        self.engine = (self.config.engine
                       or default_engine(self.devices[0].platform))
        self.costs: list[ViterbiCosts] = [
            build_costs(p, self.config.multi_hits, self.config.hmmer3_compat)
            for p in profiles
        ]
        self._scorer_spec = scorer
        self.scorer = self._make_scorer()
        self._decoders: dict[int, Decoder] = {}
        self.progress_done = 0
        self.progress_total = 0
        self.metrics = None  # set per run()
        self._checkpoint = False
        self._dev_codes = None  # set per run()

    def _make_scorer(self):
        scorer = self._scorer_spec
        if scorer is not None:
            return scorer(self.costs) if callable(scorer) else scorer
        if self.engine == "native":
            # Multithreaded striped-SIMD CPU engine (native/): the host
            # fallback and the measured reads/s baseline (BASELINE.md).
            from ..native import NativePairScorer

            return NativePairScorer(
                self.costs, nthreads=self.config.num_threads or None)
        return PairScorer(self.costs, backend=self.engine,
                          devices=self.devices)

    def release(self) -> None:
        """Free engine state held between runs: per-bucket scorers (the
        device-resident profile tables) and decoder memos.  The next
        run() rebuilds them.  This is the uncached mode of the
        reference's workload cache (c-core/workload.c:21-64: cache=false
        re-reads every protein from disk per work, trading time for
        memory) — here the trade is device HBM instead of host RAM."""
        if self.scorer is not None and hasattr(self.scorer, "release"):
            self.scorer.release()
        self.scorer = None
        self._decoders.clear()

    # ------------------------------------------------------------------
    class Interrupted(RuntimeError):
        pass

    def warmup(self, read_lengths: list[int] | None = None,
               reads_per_length: int = 1) -> float:
        """AOT shape warmup: compile the scan's kernel programs ahead of
        the first real batch by scanning synthetic reads of the expected
        lengths.  Shapes land in the persistent XLA cache
        (utils/jaxcache.py), so one warmup per (database, read-length
        profile) amortizes over every later scan on the machine.
        Returns the wall seconds spent.

        Compiled shapes follow the pair count of each wave and, for the
        plain engine, the window lengths, so pass the read lengths you
        expect in production (e.g. `read_lengths=[10000]`,
        `reads_per_length=16`).  The default — one full-window read per
        distinct core size plus a 10 knt read, the common
        long-read-sequencing scale — covers each bucket's whole-read and
        windowed shapes."""
        import tempfile
        import time as _time

        from .sequence import Sequence

        if read_lengths is None:
            read_lengths = sorted({
                min(p.core_size * 50, 100000) for p in self.profiles}
                | {10000})
        rng = np.random.default_rng(0)
        seqs = [
            Sequence.make(i * reads_per_length + j,
                          f"warmup{i}.{j}",
                          "".join("ACGT"[b]
                                  for b in rng.integers(0, 4, size=n)))
            for i, n in enumerate(read_lengths)
            for j in range(reads_per_length)
        ]
        t0 = _time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            self.run(seqs, tmp + "/warmup")
        return _time.perf_counter() - t0

    def run(self, sequences: list[Sequence], product_dir: str,
            checkpoint: bool = False, should_stop=None) -> str:
        from ..logging import ScanMetrics, get_logger

        self.metrics = ScanMetrics()
        log = get_logger("deciphon_tpu.scan")
        if self.scorer is None:  # released by an uncached prior run
            self.scorer = self._make_scorer()
        writer = ProductWriter(product_dir)
        self._checkpoint = checkpoint
        done_pairs: set[tuple[int, int]] = set()
        if checkpoint:
            done_pairs = writer.load_checkpoint()
            if done_pairs:
                log.info("resuming scan: %d pairs already complete",
                         len(done_pairs))
        # Scan-resident device codes: one upload per run; scoring calls
        # then ship only window metadata.
        self._dev_codes = None
        if hasattr(self.scorer, "make_device_codes"):
            with self.metrics.timed("seq_upload"):
                self._dev_codes = self.scorer.make_device_codes(sequences)
                self.scorer.set_device_codes(self._dev_codes)
        if hasattr(self.scorer, "set_metrics"):
            self.scorer.set_metrics(self.metrics)
        elif hasattr(self.scorer, "metrics"):
            self.scorer.metrics = self.metrics
        P, S = len(self.profiles), len(sequences)
        self.progress_total = max(P * S, 1)
        self.progress_done = 0

        # -- speculative window chains ---------------------------------
        # The serial dependency of the reference's window walk is the
        # last-hit feedback (window.c:21-27), which only acts when a hit
        # lands.  Each cursor therefore speculates up to `depth` windows
        # ahead assuming no new hit; when a hit's last_hit_pos differs
        # from the speculated state, the cursor REWINDS to the exact
        # post-hit serial state and its outstanding windows are discarded
        # and regenerated — so the processed window sequence is exactly
        # the reference's serial walk, while scoring runs in deep waves
        # with wave k+1 dispatched before wave k's results are collected
        # (device never idles on the host round trip).
        cursors: dict[tuple[int, int], WindowCursor] = {}
        chains: dict[tuple[int, int], list[PairItem]] = {}
        depth: dict[tuple[int, int], int] = {}
        exhausted: set[tuple[int, int]] = set()
        finished: set[tuple[int, int]] = set()
        max_depth = max(1, self.config.spec_depth)

        for p in range(P):
            K = self.profiles[p].core_size
            for s in range(S):
                if (p, s) in done_pairs:
                    self.progress_done += 1
                    continue
                cur = WindowCursor(K, sequences[s].size)
                cursors[(p, s)] = cur
                chains[(p, s)] = []
                # hit-free cursors (the common case) score their whole
                # expected chain in the first wave; a rewind drops the
                # depth to 1 and regrows it
                depth[(p, s)] = min(max_depth, cur.estimate_windows())

        def refill(key) -> None:
            if key in exhausted or key in finished:
                return
            cur = cursors[key]
            chain = chains[key]
            while len(chain) < depth[key]:
                item = self._next_item(key[0], key[1], cur, sequences)
                if item is None:
                    exhausted.add(key)
                    break
                item.post_state = cur.state()
                chain.append(item)

        def finish_ready() -> None:
            for key in chains:
                if (key in exhausted and not chains[key]
                        and key not in finished):
                    finished.add(key)
                    self.progress_done += 1
                    if self._checkpoint:
                        writer.journal_pair_done(*key)

        with self.metrics.timed("windowing"):
            for key in chains:
                refill(key)
            finish_ready()

        # Wave size scales with the profile count, so that a large
        # database still sends each bucket enough pairs per call to
        # fill the device.
        cap = max(self.config.max_pairs * 8, P * 64)
        can_pipeline = hasattr(self.scorer, "dispatch_all")

        def assemble() -> list[PairItem]:
            # Round-robin across (profile, sequence) chains: serial
            # (p, s)-ordered filling starved late profiles' buckets in
            # early waves and left buckets idle while others drained.
            # Interleaving keeps every bucket fed a representative mix
            # each wave; product order is restored at write time, so
            # wave composition never affects output.
            wave: list[PairItem] = []
            pending = [iter(chains[key]) for key in sorted(chains)]
            while pending and len(wave) < cap:
                nxt = []
                for itr in pending:
                    for it in itr:
                        if not it.dispatched:
                            it.dispatched = True
                            wave.append(it)
                            nxt.append(itr)
                            break
                    if len(wave) >= cap:
                        break
                pending = nxt
            return wave

        def lrt_pass(items, scores) -> list[tuple[PairItem, float]]:
            """LRT filter of one collected wave; returns the survivors."""
            self.metrics.pairs_batches += 1
            survivors: list[tuple[PairItem, float]] = []
            for it in items:
                key = (it.p_idx, it.s_idx)
                if not it.valid:
                    self.metrics.wasted_windows += 1
                    continue
                chains[key].remove(it)
                self.metrics.add_window(
                    it.win.length, self.profiles[it.p_idx].core_size)
                null_c, alt_c = scores[id(it)]
                line_lrt = lrt(null_c, alt_c)
                if math.isfinite(line_lrt) and line_lrt >= 0:
                    survivors.append((it, line_lrt))
            return survivors

        def process(survivors, paths) -> None:
            rewound: dict = {}  # key -> rewind cutoff window idx
            with self.metrics.timed("phase2_decode"):
                for it, line_lrt in survivors:
                    key = (it.p_idx, it.s_idx)
                    if (not it.valid or (key in rewound
                                         and it.win.idx > rewound[key])):
                        # discarded by an earlier hit's rewind — the
                        # serial walk regenerates this cursor's windows
                        self.metrics.wasted_windows += 1
                        continue
                    self.metrics.survivors += 1

                    def on_hit_pos(pos, it=it, key=key):
                        cur = cursors[key]
                        if pos == it.post_state[3]:
                            return  # speculation state already matches
                        # rewind to the exact post-hit serial state and
                        # discard every speculated later window
                        cur.restore(it.post_state)
                        cur.set_last_hit_position(pos)
                        for later in chains[key]:
                            later.valid = False
                        chains[key].clear()
                        exhausted.discard(key)
                        depth[key] = 1
                        rewound[key] = it.win.idx

                    self._phase2(it, sequences[it.s_idx], line_lrt,
                                 on_hit_pos, writer, paths[id(it)])
            with self.metrics.timed("windowing"):
                for key in chains:
                    if key not in rewound and depth[key] < max_depth:
                        depth[key] = min(depth[key] * 2, max_depth)
                    refill(key)
                finish_ready()

        inflight = None  # (handle, items) of the dispatched-ahead wave
        while True:
            if should_stop is not None and should_stop():
                # interrupt contract (c-core/scan.c:199-204): stop between
                # scoring waves; with checkpointing the journal preserves
                # finished pairs for a later resume.  Release the device
                # code buffer on the way out.
                if self._dev_codes is not None:
                    self.scorer.set_device_codes(None)
                    self._dev_codes = None
                raise Scanner.Interrupted("scan interrupted")
            if can_pipeline:
                # Phase-ordering for overlap: collect wave k's phase-1,
                # ENQUEUE wave k's path kernels, THEN dispatch wave
                # k+1's phase-1 (which queues behind the small path
                # passes), and only then fetch/decode wave k's paths —
                # so the step-array fetch waits for the path kernels
                # alone while wave k+1's phase-1 overlaps the host-side
                # decode/product work.
                survivors, pend = [], []
                if inflight is not None:
                    prev_handle, prev_items = inflight
                    scores = self.scorer.collect_all(prev_handle)
                    survivors = lrt_pass(prev_items, scores)
                    pend = self._batched_paths_dispatch(survivors)
                wave = assemble()
                handle = self.scorer.dispatch_all(wave) if wave else None
                if inflight is not None:
                    process(survivors, self._batched_paths_collect(pend))
                inflight = (handle, wave) if wave else None
                if inflight is None and not any(chains.values()):
                    break
            else:
                wave = assemble()
                if not wave:
                    break
                survivors = lrt_pass(wave, self.scorer.score(wave))
                pend = self._batched_paths_dispatch(survivors)
                process(survivors, self._batched_paths_collect(pend))

        with self.metrics.timed("write"):
            writer.sort_lines()
            self.metrics.products = len(writer.lines)
            log.info("scan done: %s", self.metrics.summary())
            out = writer.close()
        # release the scan-resident device code buffer (the next run
        # uploads its own batch)
        if self._dev_codes is not None:
            self.scorer.set_device_codes(None)
            self._dev_codes = None
        return out

    def _next_item(self, p: int, s: int, cur: WindowCursor,
                   sequences) -> PairItem | None:
        win = cur.next()
        if win is None:
            return None
        dev = self._dev_codes
        return PairItem(
            p_idx=p, s_idx=s, win=win, seq=sequences[s],
            gstart=dev.gstart(s, win.start) if dev is not None else -1,
            multi_hits=self.config.multi_hits,
            hmmer3_compat=self.config.hmmer3_compat,
        )

    @property
    def progress(self) -> int:
        if not self.progress_total:
            return 0
        return 100 * self.progress_done // self.progress_total

    # ------------------------------------------------------------------
    def _decoder(self, p_idx: int) -> Decoder:
        if p_idx not in self._decoders:
            self._decoders[p_idx] = Decoder(self.profiles[p_idx])
        return self._decoders[p_idx]

    # Device-memory cap for one batched path call: the packed trellis is
    # ~(2K+8) bytes per position per survivor, so chunk groups to bound it.
    PATH_BATCH_BYTES = 256 << 20

    def _batched_paths_dispatch(self, survivors) -> list:
        """Enqueue path-mode Viterbi + device traceback for every LRT
        survivor of one scoring round WITHOUT fetching results.

        Survivors are grouped by (profile, padded window length); each
        group runs as one vmapped path pass (ops/viterbi_jax.py
        viterbi_path_batch) whose trellis is immediately consumed by the
        DEVICE-side traceback walk (ops/traceback.py unzip_device_batch)
        — only the (state, size) step arrays cross to the host, not the
        (L, K) trellis.  The per-survivor lax.scan of the reference flow
        (c-core/thread.c:126) stays only as the group-of-one case.
        Returns the in-flight entry list for _batched_paths_collect."""
        from ..ops.traceback import _unzip_batch_jit
        from ..ops.viterbi_jax import viterbi_path_batch

        m = self.metrics

        sitems = [it for it, _ in survivors]
        inflight: list[tuple] = []
        groups: dict[tuple[int, int], list[PairItem]] = {}
        for it in sitems:
            groups.setdefault((it.p_idx, _pad_len(it.win.length)),
                              []).append(it)
        inflight_bytes = 0
        early: dict[int, list] = {}

        def collect(entries):
            self._collect_path_entries(entries, early)

        for (p_idx, Lpad), items in groups.items():
            costs = self.costs[p_idx]
            K = self.profiles[p_idx].core_size
            per = Lpad * (2 * K + 8)
            chunk = max(1, self.PATH_BATCH_BYTES // max(per, 1))
            dev = (jnp.asarray(costs.core), jnp.asarray(costs.match),
                   jnp.asarray(costs.null), jnp.asarray(costs.background))
            for i0 in range(0, len(items), chunk):
                sub = items[i0:i0 + chunk]
                t0 = time.perf_counter()
                # pad the batch dim to a power of two: the survivor count
                # varies freely and would key a fresh (slow) lax.scan
                # compile per count; pad rows carry length 0
                Bp = 1
                while Bp < len(sub):
                    Bp *= 2
                codes = np.zeros((Bp, Lpad, 5), np.int32)
                xts = np.zeros((Bp, 13), np.float32)
                lengths = np.zeros((Bp,), np.int32)
                for b, it in enumerate(sub):
                    codes[b, :it.win.length] = it.codes
                    xts[b] = it.xt
                    lengths[b] = it.win.length
                _, xn, nd = viterbi_path_batch(
                    *dev, jnp.asarray(xts), jnp.asarray(codes),
                    jnp.asarray(lengths))
                sts, szs, ns, oks = _unzip_batch_jit(
                    xn, nd, jnp.asarray(lengths),
                    max_steps=Lpad + 4 * K + 64)
                if m is not None:
                    m.add_wall("phase2_path", time.perf_counter() - t0)
                # bound the aggregate in-flight trellis bytes: a
                # survivor-heavy round would otherwise queue every
                # group's buffers at once and OOM the device despite the
                # per-call chunking.
                nbytes = len(sub) * per
                inflight.append((sub, sts, szs, ns, oks, xn, nd, lengths,
                                 K, nbytes))
                inflight_bytes += nbytes
                while (inflight_bytes > self.PATH_BATCH_BYTES
                       and len(inflight) > 1):
                    old = inflight.pop(0)
                    collect([old])
                    inflight_bytes -= old[9]
        if early:
            inflight.append(early)
        return inflight

    def _collect_path_entries(self, entries, out: dict) -> None:
        # one batched transfer of the step arrays (~KB per survivor)
        import jax

        from ..ops.traceback import assemble_path_entries

        t0 = time.perf_counter()
        flat = jax.device_get(
            [a for e in entries for a in (e[1], e[2], e[3], e[4])])
        if self.metrics is not None:
            self.metrics.add_wall("phase2_collect",
                                  time.perf_counter() - t0)
        assemble_path_entries([e[:9] for e in entries], flat, out)

    def _batched_paths_collect(self, inflight) -> dict[int, list]:
        """Fetch the step arrays of every entry _batched_paths_dispatch
        queued (ONE device_get for the whole wave) and assemble
        {id(item) -> (sids, sizes)}."""
        out: dict[int, list] = {}
        entries = []
        for e in inflight:
            if isinstance(e, dict):  # early-collected under the byte cap
                out.update(e)
            else:
                entries.append(e)
        if entries:
            self._collect_path_entries(entries, out)
        return out

    def _phase2(self, it: PairItem, seq: Sequence, line_lrt: float,
                on_hit_pos, writer: ProductWriter,
                path: tuple) -> None:
        p_idx, win = it.p_idx, it.win
        profile = self.profiles[p_idx]
        sids_all, sizes_all = path  # (n,) int64 arrays, S..T order

        seg = segment_hits(sids_all, sizes_all)
        if seg is None:
            return  # no B state: cursor's last_hit_pos stays -1
        begin, end, hit_start, hit_stop, last_hit_pos, found_hit = seg
        on_hit_pos(last_hit_pos)
        if not found_hit:
            return  # B without E: empty amino -> no product (thread.c flow)

        window_syms = seq.data[win.start:win.stop]
        decoder = self._decoder(p_idx)
        aminos: list[str] = []
        pos0 = int(sizes_all[:begin].sum())

        # Vectorized step assembly (the per-survivor host decode was the
        # measured hot spot of survivor-heavy scans): fragment codes come
        # straight from the window's precomputed END-indexed code table
        # (code of the fragment ending at e with duration d sits at
        # codes[e-1, d-1]) instead of per-step Python re-encoding, and
        # state names are memoized.
        sids = sids_all[begin:end]
        sizes = sizes_all[begin:end]
        ends = pos0 + np.cumsum(sizes)
        starts_rel = ends - sizes
        cls = sids >> 14
        is_x = cls == 3
        mute = (cls == 2) | (is_x & (np.isin(sids & 0x3FFF,
                                             (st.STATE_S & 0x3FFF,
                                              st.STATE_B & 0x3FFF,
                                              st.STATE_E & 0x3FFF,
                                              st.STATE_T & 0x3FFF))))
        emit = (~mute) & (sizes > 0)
        codes_win = it.codes  # (L, 5) END-indexed window fragment codes
        emit_pos = np.nonzero(emit)[0]
        fcs = codes_win[ends[emit_pos] - 1, sizes[emit_pos] - 1]

        names = [_state_name_cached(int(s)) for s in sids]
        frags = [window_syms[s:e] for s, e in zip(starts_rel, ends)]
        # pre-render every step as its final "frag,STATE,codon,amino"
        # string (mute default), then patch the emitting ones: building
        # strings directly skips per-step MatchStep construction + a
        # second render pass (measured survivor-heavy host cost)
        steps = [f + "," + nm + ",," for f, nm in zip(frags, names)]
        for i, (codon, amino) in zip(
                emit_pos,
                decoder.decode_batch([int(sids[i]) for i in emit_pos],
                                     fcs)):
            steps[i] = f"{frags[i]},{names[i]},{codon},{amino}"
            aminos.append(amino)

        line = ProductLine(
            sequence=seq.id, window=win.idx, window_start=win.start,
            window_stop=win.stop, hit=0, hit_start=hit_start,
            hit_stop=hit_stop, profile=profile.accession, abc=self.abc_name,
            lrt=line_lrt, logevalue=0.0, steps=steps)

        amino_seq = "".join(aminos)
        if self.confirmer is not None:
            if len(amino_seq) + 1 > HMMER_MAX_AMINO:
                # HMMER3 can't confirm >100k aminos: skip ONLY the
                # confirmation, still write the match line
                # (thread.c:182-207 — add_match is outside the guard).
                pass
            else:
                logevalue, blob = self.confirmer(p_idx, amino_seq)
                if logevalue > 0:
                    logevalue = 0.0
                if logevalue == 0:
                    return
                line.logevalue = logevalue
                if blob is not None:
                    writer.add_h3r(line, blob)
        else:
            if not amino_seq:
                return
        order = (p_idx, seq.id, win.idx)
        writer.add(line, order=order)
        if self._checkpoint:
            writer.journal_line(line, order, (p_idx, it.s_idx))


def segment_hits(sids: np.ndarray, sizes: np.ndarray):
    """Hit segmentation over a traced path (c-core/thread.c:130-166).

    Takes the path as (n,) int64 arrays in S..T order.  Returns
    (begin_idx, end_idx, hit_start, hit_stop, last_hit_pos, found_hit)
    over the span from the first B to one past the last E, or None when
    no B state exists (then last_hit_pos stays -1, matching the
    reference's early return).  hit_start/hit_stop are window-relative
    nucleotide positions; last_hit_pos is always hit_stop-1 once a B was
    seen (the reference sets it at loop exit even with no E).

    Vectorized but exactly the reference walk: hit_start = emitted
    nucleotides before the first B; hit_stop accumulates every non-E
    step between B and the LAST E (E steps are mute, size 0, so a plain
    slice sum matches the step-skipping loop).
    """
    b_idx = np.nonzero(sids == st.STATE_B)[0]
    if len(b_idx) == 0:
        return None
    begin = int(b_idx[0])
    hit_start = int(sizes[:begin].sum())

    e_idx = np.nonzero(sids[begin + 1:] == st.STATE_E)[0]
    if len(e_idx) == 0:
        return begin, begin + 1, hit_start, hit_start, hit_start - 1, False
    last_e = begin + 1 + int(e_idx[-1])
    hit_stop = hit_start + int(sizes[begin + 1:last_e].sum())
    return begin, last_e + 1, hit_start, hit_stop, hit_stop - 1, True
