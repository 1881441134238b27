"""The remote worker: consumes press/scan jobs from the scheduler.

Parity: cli/deciphon/worker.py — the reference subscribes to MQTT topics
and forks Press/Scan processes per (db, flags); this worker long-polls the
scheduler's durable queue (GET /queue/{topic}), downloads artifacts it is
missing, runs the press/scan engines, posts progress PATCHes and uploads
results, and reports failures upstream (JobUpdate.fail).  Scanner daemons
are cached per (db, multi_hits, hmmer3_compat) like the reference's
consumer keying (worker.py:74-90,184-200).
"""

from __future__ import annotations

import os
import tempfile
import traceback

import click

from .poster import Poster
from .schema import PressRequest, ScanRequest

__all__ = ["worker", "WorkerLoop"]


class WorkerLoop:
    def __init__(self, poster: Poster, workdir: str | None = None,
                 engine: str | None = None, confirm: str = "none"):
        self.poster = poster
        self.workdir = workdir or tempfile.mkdtemp(prefix="deciphon_worker_")
        os.makedirs(self.workdir, exist_ok=True)
        self.engine = engine
        self.confirm = confirm
        self._scanners: dict[tuple, object] = {}

    # ------------------------------------------------------------------
    def poll_once(self, timeout: float = 5.0) -> bool:
        """Claim and run at most one job; returns whether one ran."""
        msg = self.poster.queue_next("press", timeout=0)
        if msg is not None:
            self._run_press(PressRequest.model_validate(msg))
            return True
        msg = self.poster.queue_next("scan", timeout=timeout)
        if msg is not None:
            self._run_scan(ScanRequest.model_validate(msg))
            return True
        return False

    def run_forever(self) -> None:  # pragma: no cover - CLI loop
        while True:
            try:
                self.poll_once(timeout=5.0)
            except KeyboardInterrupt:
                raise
            except Exception:
                traceback.print_exc()

    # ------------------------------------------------------------------
    def _fetch(self, kind: str, name: str) -> str:
        dest = os.path.join(self.workdir, name)
        if not os.path.exists(dest):
            self.poster.download(kind, name, dest)
        return dest

    def _run_press(self, req: PressRequest) -> None:
        job = self.poster.job_update(req.job_id)
        try:
            job.run(0)
            hmm_path = self._fetch("hmms", req.hmm.name)
            dcp_path = os.path.join(self.workdir, req.db.name)

            from .press import press

            press(hmm_path, dcp_path, int(req.gencode), req.epsilon,
                  progress=lambda d, t: job.run(100 * d // t))
            self.poster.upload("dbs", dcp_path)
            self.poster.db_post(req.db.name)
            job.done()
        except Exception as exc:
            traceback.print_exc()
            job.fail(str(exc)[:500])

    def _scanner_for(self, req: ScanRequest):
        key = (req.db.name, req.multi_hits, req.hmmer3_compat)
        if key not in self._scanners:
            dcp_path = self._fetch("dbs", req.db.name)
            confirmer = None
            if self.confirm == "native":
                from .hmmer.forward import NativeConfirmer
                from .hmmfile import read_hmm

                hmm_path = self._fetch("hmms", req.hmm.name)
                confirmer = NativeConfirmer(read_hmm(hmm_path)).confirm

            from .io.dcp import read_dcp_profiles
            from .scan.pipeline import ScanConfig, Scanner

            _, profiles = read_dcp_profiles(dcp_path)
            cfg = ScanConfig(multi_hits=req.multi_hits,
                             hmmer3_compat=req.hmmer3_compat,
                             engine=self.engine)
            self._scanners[key] = Scanner(profiles, cfg, confirmer=confirmer)
        return self._scanners[key]

    def _run_scan(self, req: ScanRequest) -> None:
        job = self.poster.job_update(req.job_id)
        try:
            job.run(0)
            scanner = self._scanner_for(req)

            from .scan.sequence import Sequence
            from .snap.snap_file import make_snap_archive

            seqs = [Sequence.make(s.id, s.name, s.data) for s in req.seqs]
            base = os.path.join(self.workdir, f"scan_{req.id}")
            basedir = os.path.join(base, f"scan_{req.id}")
            os.makedirs(basedir, exist_ok=True)
            scanner.run(seqs, basedir)
            dcs = make_snap_archive(basedir, base + ".dcs")
            self.poster.snap_post(req.id, dcs)  # sched marks the job done
            import shutil

            shutil.rmtree(base, ignore_errors=True)
            os.unlink(dcs)
        except Exception as exc:
            traceback.print_exc()
            job.fail(str(exc)[:500])


@click.command()
@click.option("--sched", "sched_url", required=True,
              help="Scheduler base URL, e.g. http://127.0.0.1:49329")
@click.option("--engine", type=click.Choice(["cuda", "jax"]), default=None,
              help="Phase-1 engine [default: cuda on a GPU, jax on the CPU]")
@click.option("--confirm", type=click.Choice(["none", "native"]),
              default="none", show_default=True)
@click.option("--workdir", default=None)
def worker(sched_url, engine, confirm, workdir):
    """Consume press/scan jobs from a scheduler until interrupted."""
    poster = Poster(sched_url)
    poster.handshake()
    loop = WorkerLoop(poster, workdir=workdir, engine=engine,
                      confirm=confirm)
    click.echo(f"worker consuming from {sched_url}")
    loop.run_forever()
