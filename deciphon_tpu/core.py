"""Engine-level compatibility API (parity: python-core/deciphon_core).

The reference's lowest Python layer wraps the C engine with four objects:
`PressContext`, `Scan`, `Batch`, `Sequence` plus `DeciphonError`
(python-core/deciphon_core/{press,scan,batch,sequence,error}.py).  Users
migrating from deciphon find the same surface here, backed by the JAX
engines; `port`/`num_threads` are accepted for signature compatibility
(threads are meaningless under one device program per wave; a port
wires the hmmpgmd confirmer exactly like the reference).
"""

from __future__ import annotations

from dataclasses import dataclass

from .press import PressContext
from .scan.pipeline import ScanConfig, Scanner
from .scan.sequence import Sequence as _PreparedSequence
from .schema import DBFile, NewSnapFile

__all__ = ["PressContext", "Scan", "Batch", "Sequence", "DeciphonError"]


class DeciphonError(RuntimeError):
    pass


@dataclass
class Sequence:
    """(id, name, data) triple (python-core/deciphon_core/sequence.py:6)."""

    id: int
    name: str
    data: str


class Batch:
    """A batch of query sequences (python-core/deciphon_core/batch.py:8)."""

    def __init__(self):
        self._seqs: list[Sequence] = []

    def add(self, sequence: Sequence) -> None:
        self._seqs.append(sequence)

    def reset(self) -> None:
        self._seqs = []

    def prepared(self) -> list[_PreparedSequence]:
        return [_PreparedSequence.make(s.id, s.name, s.data)
                for s in self._seqs]

    def __len__(self) -> int:
        return len(self._seqs)


class Scan:
    """Scan object (python-core/deciphon_core/scan.py:23).

    A Scan may be run() repeatedly over fresh batches (the reference's
    reuse flow, c-core/test_scan.c:50-78); each run writes its own
    product set into the snap dir, truncating any previous products.tsv
    exactly like the reference's "wb" open (c-core/product.c:46).

    `cache=True` keeps engine state (device-resident profile tables,
    decoder memos) alive between run() calls; `cache=False` releases it
    after each run and rebuilds on the next — the reference's workload
    cache trade (c-core/workload.c:21-64: cached works stay in memory vs
    re-reading proteins per work), with device HBM as the resource here.

    `num_threads` drives the host ("native") engine's thread fan-out;
    device engines run one jitted program per wave, so the flag has no
    effect there (the batch dim plays the role of the reference's
    OpenMP threads, c-core/scan.c:137-160).
    """

    def __init__(self, dbfile: DBFile, port: int = 0, num_threads: int = 1,
                 multi_hits: bool = True, hmmer3_compat: bool = False,
                 cache: bool = False, engine: str | None = None):
        from .io.dcp import read_dcp_profiles

        self._cache = cache
        try:
            _, profiles = read_dcp_profiles(str(dbfile.path))
        except Exception as exc:
            raise DeciphonError(f"cannot open database: {exc}") from exc
        confirmer = None
        if port:
            from .hmmer.client import HMMERClient

            client = HMMERClient("127.0.0.1", port,
                                 num_proteins=len(profiles),
                                 has_ga=all(p.has_ga for p in profiles))
            confirmer = client.confirm
        self._scanner = Scanner(
            profiles,
            ScanConfig(multi_hits=multi_hits, hmmer3_compat=hmmer3_compat,
                       engine=engine, num_threads=num_threads),
            confirmer=confirmer)
        self.interrupted = False

    def run(self, snap: NewSnapFile, batch: Batch) -> None:
        self.interrupted = False
        try:
            basedir = snap.basedir
            basedir.mkdir(parents=True, exist_ok=True)
            self._scanner.run(batch.prepared(), str(basedir),
                              should_stop=lambda: self.interrupted)
        except Scanner.Interrupted:
            pass  # reference semantics: interrupted run returns quietly
        except Exception as exc:
            raise DeciphonError(str(exc)) from exc
        finally:
            if not self._cache:
                # uncached mode: free engine state between runs
                # (workload.c:21-64 cache=false analog)
                self._scanner.release()

    def interrupt(self) -> None:
        self.interrupted = True

    def progress(self) -> int:
        return self._scanner.progress

    def free(self) -> None:
        pass
