"""Batch scheduler: ragged (profile, window) pairs -> one device call per
K bucket and wave.

The re-architecture of the reference's scan orchestration
(c-core/scan.c:167-216 + thread.c:49-86): instead of one OpenMP thread per
contiguous protein partition, every (profile, window) in flight is scored
at once.  Profiles are grouped into buckets of equal padded node count;
each wave's pairs of a bucket go to the device in one call, which returns
the (null, alt) costs of every pair.

Two backends share the bucketing, the table residency and the dispatch
contract: "cuda", the Hopper kernel (ops/viterbi_cuda.py, one thread block
per pair), and "jax", the plain lax.scan engine vmapped over the pairs
(ops/engine.py scan_pairs), which is the reference and the CPU path.

Window advancement stays per-(profile, sequence) sequential with last-hit
feedback, exactly like the reference (c-core/window.c:13-37): only one
window per cursor is ever in flight; batching comes from the cross product
of profiles and sequences.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np

from ..ops.costs import ViterbiCosts, build_tables
from ..xtrans import xtrans_cost_vector
from .window import Window

BACKENDS = ("cuda", "jax")


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def prev_pow2(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class PairItem:
    """One scheduled window with its origin coordinates.

    `codes` (the (len, 5) END-indexed window fragment codes) is computed
    lazily from the origin sequence: phase-1 scoring never touches it (it
    reads the scan-resident device codes by `gstart`), so only LRT
    survivors and host-side engines pay the O(L) precompute.
    """

    __slots__ = ("p_idx", "s_idx", "win", "multi_hits", "hmmer3_compat",
                 "seq", "gstart", "_codes", "post_state", "valid",
                 "dispatched")

    def __init__(self, p_idx: int, s_idx: int, win: Window,
                 multi_hits: bool, hmmer3_compat: bool,
                 codes: np.ndarray | None = None, seq=None,
                 gstart: int = -1):
        self.p_idx = p_idx
        self.s_idx = s_idx
        self.win = win
        self.multi_hits = multi_hits
        self.hmmer3_compat = hmmer3_compat
        self.seq = seq
        self.gstart = gstart
        self._codes = codes
        # speculation bookkeeping (scan/pipeline.py): the cursor state
        # right after this window was generated, whether the window is
        # still part of the serial walk, and whether a wave carries it
        self.post_state = None
        self.valid = True
        self.dispatched = False

    @property
    def codes(self) -> np.ndarray:
        if self._codes is None:
            self._codes = self.seq.window_codes(self.win.start, self.win.stop)
        return self._codes

    @property
    def xt(self) -> np.ndarray:
        return xtrans_cost_vector(self.multi_hits, self.hmmer3_compat,
                                  self.win.length)


def _start_codes_compute(b8):
    from ..frame import FRAG_OFFSETS

    import jax.numpy as jnp

    b = b8.astype(jnp.int32)
    cols = []
    for t in range(1, 6):
        v = jnp.zeros_like(b)
        for i in range(t):
            v = v * 4 + jnp.roll(b, -i)
        cols.append(FRAG_OFFSETS[t - 1] + v)
    return jnp.stack(cols, axis=1)


@functools.lru_cache(maxsize=1)
def _start_codes_jit():
    import jax

    return jax.jit(_start_codes_compute)


class DeviceSeqCodes:
    """Scan-resident START-indexed fragment codes, uploaded once per scan.

    Concatenates every sequence's bases into one array and derives, on the
    device, a (Tpad, 5) int32 array whose row p holds the codes of the 5
    fragments starting at global position p (frame.py layout).  Scoring
    calls then ship only per-pair start offsets.  Fragments that cross a
    sequence boundary are only ever read for DP positions past a window's
    end, which no scorer captures, so concatenation needs no separators.
    """

    ROW_QUANTUM = 1 << 16  # pad T to quantized shapes: bounded jit keys

    def __init__(self, sequences, device=None):
        import jax

        self.offsets: list[int] = []
        total = 0
        parts = []
        for s in sequences:
            self.offsets.append(total)
            parts.append(s.symbols)
            total += s.size
        # one row past the data, so pad pairs start past every real row
        tpad = -(-(total + 1) // self.ROW_QUANTUM) * self.ROW_QUANTUM
        # ship 1 byte/nt of bases and derive the 20 bytes/nt code table on
        # the device: the host link is the cost
        host = np.zeros((tpad,), np.int8)
        if parts:
            host[:total] = np.concatenate(parts)
        self.total = total
        self.dev = _start_codes_jit()(jax.device_put(host, device))
        self.pad_start = tpad - 1

    def gstart(self, s_idx: int, win_start: int) -> int:
        return self.offsets[s_idx] + win_start


def device_table_budget(devices=None) -> int:
    """Device bytes available for RESIDENT profile tables.

    DECIPHON_HBM_BUDGET overrides (bytes).  Otherwise the device's memory
    limit minus a working reserve (code arrays, in-flight wave buffers,
    scratch): on a GPU the limit is `bytes_limit` of `memory_stats()`,
    JAX's preallocated pool, and a GPU that does not report it is an
    error.  The CPU backend reports no limit; its tables live in host
    memory, bounded by the machine's physical memory.
    """
    env = os.environ.get("DECIPHON_HBM_BUDGET")
    if env:
        return int(env)
    import jax

    dev = (devices or jax.local_devices())[0]
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if not limit:
        if dev.platform != "cpu":
            raise RuntimeError(
                f"{dev.device_kind} reports no memory limit "
                "(memory_stats()['bytes_limit']); set DECIPHON_HBM_BUDGET")
        limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    reserve = max(int(limit * 0.25), 2 << 30)
    return max(limit - reserve, 1 << 30)


class HBMLedger:
    """Capacity ledger for per-bucket table residency.

    The reference's design point is a 32 x 4 GB database streamed from
    disk through per-partition iterators (c-core/database_writer.c:14,
    protein_reader.c:77-101); a realistic Pfam press can outgrow one
    device's memory.  The ledger assigns buckets to RESIDENT device tables
    until the budget runs out; the remainder STREAM host->device per wave
    (PairScorer), trading upload bandwidth for unbounded database size
    instead of running out of memory.  Biggest buckets stream first —
    their per-byte upload amortizes over the most compute.
    """

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self.resident: list[tuple[int, int]] = []  # (bucket idx, bytes)
        self.streamed: list[tuple[int, int]] = []

    def plan(self, sizes: list[int]) -> list[bool]:
        """sizes[i] = table bytes of bucket i; returns stream flags.
        Deterministic: larger tables considered first, so small buckets
        (the common-case hot mass) stay resident."""
        order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
        left = self.budget
        stream = [False] * len(sizes)
        for i in order:
            if sizes[i] <= left:
                left -= sizes[i]
                self.resident.append((i, sizes[i]))
            else:
                stream[i] = True
                self.streamed.append((i, sizes[i]))
        return stream

    @property
    def resident_bytes(self) -> int:
        return sum(b for _, b in self.resident)

    @property
    def streamed_bytes(self) -> int:
        return sum(b for _, b in self.streamed)


def bucket_nodes(K: int, backend: str) -> int:
    """Scored node count of the bucket a profile of K nodes joins.

    The kernel's block covers threads * nodes_per_thread nodes
    (ops/viterbi_cuda.py launch_shape), so its buckets are that width.
    The plain engine runs one XLA step per position for a whole bucket,
    whatever its width, so fewer, power-of-two buckets serve it best."""
    if backend == "cuda":
        from ..ops.viterbi_cuda import launch_shape

        threads, npt = launch_shape(K)
        return threads * npt
    return max(128, next_pow2(K))


class _Bucket:
    """Profiles of one node width, their host tables and device copies."""

    def __init__(self, kn: int, costs: list[ViterbiCosts], backend: str):
        self.kn = kn
        # the kernel's (threads, nodes per thread); unused by the plain
        # engine
        self.shape = (0, 0)
        if backend == "cuda":
            from ..ops.viterbi_cuda import launch_shape

            self.shape = launch_shape(kn)
        self.ks = np.array([c.K for c in costs], np.int64)
        built = [build_tables(c, kn) for c in costs]
        self.tables_host = np.stack([t for t, _ in built])
        self.tvecs_host = np.stack([v for _, v in built])
        self.stream = False
        self._dev = None

    @property
    def nbytes(self) -> int:
        return self.tables_host.nbytes + self.tvecs_host.nbytes

    def device_arrays(self, put):
        if self._dev is None:
            self._dev = (put(self.tables_host), put(self.tvecs_host))
        return self._dev

    def release(self) -> None:
        """Streamed buckets drop their device tables once a wave's calls
        are enqueued (the enqueued calls keep them alive until run)."""
        if self.stream:
            self._dev = None


@functools.lru_cache(maxsize=None)
def _device_fn(backend: str, mesh, threads: int, npt: int, lpad: int):
    """The jitted per-bucket call: (tables, tvecs, codes, pidx, starts,
    lens, xts) -> (alt, null); pairs sharded over `mesh` when given."""
    import jax

    if backend == "cuda":
        from ..ops.viterbi_cuda import score_pairs

        fn = functools.partial(score_pairs, threads=threads, npt=npt)
    else:
        from ..ops.engine import scan_pairs

        fn = functools.partial(scan_pairs, lpad=lpad)
    if mesh is None:
        return jax.jit(fn)
    from ..parallel.multidevice import shard_pairs

    return shard_pairs(fn, mesh)


class PairScorer:
    """Phase-1 scorer over K buckets (see the module docstring).

    `dispatch_all` enqueues one wave's device calls without blocking and
    `collect_all` fetches their costs in one transfer, so the pipeline
    overlaps a wave's device work with the host work of the previous one.
    With several `devices`, each call's pairs are sharded over a 1-D mesh
    of them and the tables are replicated (parallel/multidevice.py).
    """

    # device bytes of the plain backend's gathered window codes per call
    PLAIN_CALL_BYTES = 256 << 20
    # scratch bytes of the kernel's memory-state tier per call
    SCRATCH_CALL_BYTES = 1 << 30

    def __init__(self, costs_list: list[ViterbiCosts], backend: str,
                 devices=None, hbm_budget: int | None = None):
        import jax

        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.devices = list(devices) if devices else jax.devices()[:1]
        if backend == "cuda":
            from ..ops.viterbi_cuda import register

            register()  # a library that cannot be built or loaded raises
            if any(d.platform != "gpu" for d in self.devices):
                raise ValueError("the cuda backend needs GPU devices")
        self.mesh = None
        if len(self.devices) > 1:
            from ..parallel.multidevice import make_mesh

            self.mesh = make_mesh(self.devices)
        groups: dict[int, list[int]] = {}
        for i, c in enumerate(costs_list):
            groups.setdefault(bucket_nodes(c.K, backend), []).append(i)
        self.buckets: list[_Bucket] = []
        self._map: dict[int, tuple[int, int]] = {}
        for kn in sorted(groups):
            for local, gi in enumerate(groups[kn]):
                self._map[gi] = (len(self.buckets), local)
            self.buckets.append(
                _Bucket(kn, [costs_list[i] for i in groups[kn]], backend))

        self.ledger = HBMLedger(hbm_budget if hbm_budget is not None
                                else device_table_budget(self.devices))
        for b, stream in zip(self.buckets, self.ledger.plan(
                [b.nbytes for b in self.buckets])):
            b.stream = stream
        if self.ledger.streamed:
            from ..logging import get_logger

            get_logger("deciphon_tpu.scan").warning(
                "profile tables exceed the device budget: %d/%d buckets "
                "(%.2f GB of %.2f GB) stream host->device per wave",
                len(self.ledger.streamed), len(self.buckets),
                self.ledger.streamed_bytes / 2**30,
                self.ledger.budget / 2**30)
        self.dev_codes: DeviceSeqCodes | None = None
        self.metrics = None

    # -- placement ------------------------------------------------------
    def _put_replicated(self, x):
        import jax

        if self.mesh is None:
            return jax.device_put(x, self.devices[0])
        from jax.sharding import NamedSharding, PartitionSpec

        return jax.device_put(x, NamedSharding(self.mesh, PartitionSpec()))

    def _put_pairs(self, x):
        import jax

        if self.mesh is None:
            return jax.device_put(x, self.devices[0])
        from jax.sharding import NamedSharding, PartitionSpec

        from ..parallel.multidevice import MESH_AXIS

        return jax.device_put(
            x, NamedSharding(self.mesh, PartitionSpec(MESH_AXIS)))

    def make_device_codes(self, sequences) -> DeviceSeqCodes:
        codes = DeviceSeqCodes(sequences, self.devices[0])
        if self.mesh is not None:
            codes.dev = self._put_replicated(codes.dev)
        return codes

    def set_device_codes(self, dev_codes: DeviceSeqCodes | None) -> None:
        self.dev_codes = dev_codes

    def set_metrics(self, metrics) -> None:
        self.metrics = metrics

    def release(self) -> None:
        """Drop every bucket's device tables (rebuilt on next use)."""
        for b in self.buckets:
            b._dev = None

    # -- phase 1 --------------------------------------------------------
    def _padded(self, n: int) -> int:
        """Pair count of a call: a power of two (bounded compile shapes),
        and a multiple of the mesh size."""
        n = next_pow2(max(n, 1))
        ndev = len(self.devices)
        return -(-n // ndev) * ndev

    def _calls(self, b: _Bucket, items: list[tuple[int, PairItem]]):
        """Split one bucket's pairs into calls: [(pairs, lpad)].

        The kernel takes every window length in one call (each block runs
        its own window to its end), longest first so long blocks start
        early; only its memory-state tier bounds the pairs per call.  The
        plain engine runs lpad steps for every pair of a call, so its
        calls group windows by power-of-two length."""
        items = sorted(items, key=lambda x: (-x[1].win.length, x[1].p_idx,
                                             x[1].s_idx, x[1].win.idx))
        if self.backend == "cuda":
            from ..ops.viterbi_cuda import scratch_floats

            per = scratch_floats(1, *b.shape) * 4
            most = max(1, self.SCRATCH_CALL_BYTES // per)
            return [(items[i:i + most], 0)
                    for i in range(0, len(items), most)]
        rungs: dict[int, list] = {}
        for x in items:
            rungs.setdefault(next_pow2(max(x[1].win.length, 64)),
                             []).append(x)
        out = []
        for lpad in sorted(rungs, reverse=True):
            group = rungs[lpad]
            most = max(1, prev_pow2(self.PLAIN_CALL_BYTES // (lpad * 20)))
            out += [(group[i:i + most], lpad)
                    for i in range(0, len(group), most)]
        return out

    def dispatch_all(self, items: list[PairItem]):
        """Enqueue one wave's device calls without blocking; returns the
        handle for collect_all."""
        m = self.metrics
        by: dict[int, list[tuple[int, PairItem]]] = {}
        for it in items:
            bi, local = self._map[it.p_idx]
            by.setdefault(bi, []).append((local, it))
        calls = []
        for bi in sorted(by):
            b = self.buckets[bi]
            tables, tvecs = b.device_arrays(self._put_replicated)
            for pairs, lpad in self._calls(b, by[bi]):
                t0 = time.perf_counter()
                n = self._padded(len(pairs))
                pidx = np.zeros((n,), np.int32)
                starts = np.full((n,), self.dev_codes.pad_start, np.int32)
                lens = np.zeros((n,), np.int32)
                xts = np.zeros((n, 16), np.float32)
                for j, (local, it) in enumerate(pairs):
                    pidx[j] = local
                    starts[j] = it.gstart
                    lens[j] = it.win.length
                    xts[j, :13] = it.xt
                args = [self._put_pairs(a) for a in (pidx, starts, lens, xts)]
                t1 = time.perf_counter()
                fn = _device_fn(self.backend, self.mesh, *b.shape, lpad)
                alt, nul = fn(tables, tvecs, self.dev_codes.dev, *args)
                t2 = time.perf_counter()
                if m is not None:
                    m.add_wall("pack", t1 - t0)
                    m.add_wall("dispatch", t2 - t1)
                    true = int((lens.astype(np.int64)
                                * b.ks[pidx]).sum()) * 5
                    steps = (lpad * n if lpad else int(lens.sum()))
                    m.add_bucket_cells(f"{self.backend}_kn{b.kn}", true,
                                       steps * 5 * b.kn)
                calls.append(([it for _, it in pairs], alt, nul))
            b.release()
        return calls

    def collect_all(self, calls) -> dict[int, tuple[float, float]]:
        """Fetch every call's costs of one wave in ONE device_get;
        returns {id(item): (null_cost, alt_cost)}."""
        import jax

        t0 = time.perf_counter()
        fetched = jax.device_get([a for c in calls for a in (c[1], c[2])])
        if self.metrics is not None:
            self.metrics.add_wall("collect", time.perf_counter() - t0)
        results: dict[int, tuple[float, float]] = {}
        for i, (items, _, _) in enumerate(calls):
            alt, nul = fetched[2 * i], fetched[2 * i + 1]
            for j, it in enumerate(items):
                results[id(it)] = (float(nul[j]), float(alt[j]))
        return results

    def score(self, items: list[PairItem]) -> dict[int, tuple[float, float]]:
        return self.collect_all(self.dispatch_all(items))
