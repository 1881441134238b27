"""Command-line interface: press / scan / see (parity: cli/deciphon/cli.py).

`deciphon press FILE.hmm GENCODE` -> FILE.dcp
`deciphon scan FILE.dcp SEQS.fna` -> SEQS.dcs  (LRT-only unless --hmmer)
`deciphon see SNAP.dcs`           -> alignment view

The reference's `worker` command (MQTT consumer) lives in
deciphon_tpu.worker_daemon and is registered here when its dependencies
are available.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import click

from .gencode import GENCODE_IDS


@click.group()
def cli():
    """Deciphon on JAX: protein annotation on nucleotide long reads."""


@cli.command()
@click.argument("hmmfile", type=click.Path(exists=True, dir_okay=False))
@click.argument("gencode", type=int)
@click.option("--epsilon", type=float, default=0.01, show_default=True,
              help="Nucleotide error probability.")
@click.option("--output", type=click.Path(), default=None,
              help="Output .dcp path (default: input with .dcp suffix).")
@click.option("--progress/--no-progress", default=True)
def press(hmmfile, gencode, epsilon, output, progress):
    """Press a HMMER3 .hmm file into a .dcp frame-profile database."""
    if gencode not in GENCODE_IDS:
        raise click.BadParameter(f"unknown genetic code {gencode}")
    from .press import press as do_press

    bar = None
    if progress:
        import rich.progress as rp

        bar = rp.Progress(*rp.Progress.get_default_columns(),
                          rp.MofNCompleteColumn())
        bar.start()
        task = bar.add_task("press", total=None)

        def cb(done, total):
            bar.update(task, completed=done, total=total)
    else:
        cb = None
    try:
        out = do_press(str(hmmfile), output, gencode, epsilon, progress=cb)
    finally:
        if bar is not None:
            bar.stop()
    click.echo(f"wrote {out}")
    # hmmpgmd needs hmmpress side files (h3m/h3i/h3f/h3p); the reference
    # CLI always runs `hmmpress -f` after pressing (cli/deciphon/
    # hmmer_press.py:9-10).  Only possible when HMMER is installed.
    import shutil as _shutil
    import subprocess as _subprocess

    if _shutil.which("hmmpress"):
        _subprocess.run(["hmmpress", "-f", str(hmmfile)], check=False,
                        capture_output=True)


@cli.command()
@click.argument("dbfile", type=click.Path(exists=True, dir_okay=False))
@click.option("--read-length", "read_lengths", type=int, multiple=True,
              help="Expected read length(s); default = one full window "
                   "per distinct profile core size plus a 10 knt read. "
                   "Compiled shapes follow the reads' lengths, so pass "
                   "your production read length.")
@click.option("--reads-per-length", type=int, default=1, show_default=True,
              help="Synthetic reads per length (more reads exercise the "
                   "wider chunk shapes a deep scan uses).")
@click.option("--engine", type=click.Choice(["cuda", "jax"]), default=None,
              help="Phase-1 engine [default: cuda on a GPU, jax on the CPU]")
def warmup(dbfile, read_lengths, reads_per_length, engine):
    """Precompile the scan kernels for DBFILE into the persistent XLA
    cache (one-time per database + read-length profile): later scans
    start in seconds instead of paying the cold compile wall."""
    from .io.dcp import read_dcp_profiles
    from .scan.pipeline import ScanConfig, Scanner
    from .utils import enable_compilation_cache

    enable_compilation_cache()
    _, profiles = read_dcp_profiles(str(dbfile))
    scanner = Scanner(profiles, ScanConfig(engine=engine))
    dt = scanner.warmup(list(read_lengths) or None,
                        reads_per_length=reads_per_length)
    click.echo(f"warmup done in {dt:.1f}s "
               f"({len(profiles)} profiles, engine={scanner.engine})")


@cli.command()
@click.argument("dbfile", type=click.Path(exists=True, dir_okay=False))
@click.argument("seqfile", type=click.Path(exists=True, dir_okay=False))
@click.option("--snap", type=click.Path(), default=None,
              help="Output .dcs path (default: SEQFILE base + .dcs).")
@click.option("--multi-hits/--no-multi-hits", default=True, show_default=True)
@click.option("--hmmer3-compat/--no-hmmer3-compat", default=False,
              show_default=True)
@click.option("--engine", type=click.Choice(["cuda", "jax", "native"]),
              default=None,
              help="Phase-1 engine [default: cuda on a GPU, jax on the CPU]")
@click.option("--hmmer", "hmmer_port", type=int, default=None,
              help="Confirm hits against hmmpgmd on this port.")
@click.option("--confirm", "confirm_mode",
              type=click.Choice(["none", "native"]), default="none",
              show_default=True,
              help="E-value confirmation: 'native' runs the built-in amino "
                   "Forward scorer (needs the paired .hmm next to the .dcp).")
@click.option("--progress/--no-progress", default=True)
@click.option("--profile-dir", type=click.Path(file_okay=False), default=None,
              help="Capture a JAX/XLA profiler trace of the scan into this "
                   "directory (view with TensorBoard or Perfetto).")
def scan(dbfile, seqfile, snap, multi_hits, hmmer3_compat, engine,
         hmmer_port, confirm_mode, progress, profile_dir):
    """Scan sequences against a pressed database; write a .dcs snap."""
    from .io.dcp import read_dcp_profiles
    from .scan.fasta_io import read_sequences
    from .scan.pipeline import ScanConfig, Scanner
    from .snap.snap_file import make_snap_archive
    from .utils import enable_compilation_cache

    enable_compilation_cache()
    if snap is None:
        snap = os.path.splitext(str(seqfile))[0] + ".dcs"
    if os.path.exists(snap):
        raise click.ClickException(f"{snap} already exists")

    _, profiles = read_dcp_profiles(str(dbfile))
    sequences = read_sequences(seqfile)

    confirmer = None
    if hmmer_port is not None:
        from .hmmer.client import HMMERClient

        client = HMMERClient("127.0.0.1", hmmer_port,
                             num_proteins=len(profiles),
                             has_ga=all(p.has_ga for p in profiles))
        confirmer = client.confirm
    elif confirm_mode == "native":
        from .hmmer.forward import NativeConfirmer
        from .hmmfile import read_hmm

        hmm_path = os.path.splitext(str(dbfile))[0] + ".hmm"
        if not os.path.exists(hmm_path):
            raise click.ClickException(
                f"native confirmation needs {hmm_path} next to the .dcp")
        confirmer = NativeConfirmer(read_hmm(hmm_path)).confirm

    cfg = ScanConfig(multi_hits=multi_hits, hmmer3_compat=hmmer3_compat,
                     engine=engine)
    scanner = Scanner(profiles, cfg, confirmer=confirmer)

    workdir = tempfile.mkdtemp(prefix="deciphon_scan_")
    basedir = os.path.join(
        workdir, os.path.splitext(os.path.basename(str(snap)))[0])
    os.makedirs(basedir)
    try:
        if profile_dir:
            import contextlib

            import jax

            trace = jax.profiler.trace(profile_dir)
        else:
            import contextlib

            trace = contextlib.nullcontext()
        with trace:
            scanner.run(sequences, basedir)
        make_snap_archive(basedir, str(snap))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    click.echo(f"wrote {snap}")
    if profile_dir:
        click.echo(f"profiler trace in {profile_dir}")


@cli.command()
@click.argument("snapfile", type=click.Path(exists=True, dir_okay=False))
def see(snapfile):
    """Pretty-print the alignments stored in a .dcs snap."""
    from .snap.snap_file import read_snap
    from .snap.view import view_alignments

    snap = read_snap(snapfile)
    click.echo(str(snap))
    click.echo()
    click.echo(view_alignments(snap.products))


def _register_worker():
    try:
        from .worker_daemon import worker  # noqa: F401

        cli.add_command(worker)
    except ImportError:
        pass


_register_worker()


def main():
    cli(prog_name="deciphon")


if __name__ == "__main__":
    sys.exit(main())
