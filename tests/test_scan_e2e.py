"""End-to-end scan: press minifam -> scan the reference consensus reads.

Workload parity: c-core/test_scan.c (8 consensus sequences x flag combos).
The reference's golden fletcher16 checksums include hmmpgmd e-value
confirmation, which needs a live HMMER3 daemon; these tests run the
LRT-only product path and assert biological correctness (each consensus
read hits its own profile), determinism, and engine equivalence.
"""

import json
import os

import numpy as np
import pytest

from deciphon_tpu.io.dcp import read_dcp_profiles
from deciphon_tpu.press import press
from deciphon_tpu.scan.pipeline import ScanConfig, Scanner
from deciphon_tpu.scan.product import fletcher16
from deciphon_tpu.scan.sequence import Sequence

MINIFAM = "/root/reference/c-core/minifam.hmm"
HERE = os.path.dirname(__file__)

# consensus name -> profile accession prefix (minifam families)
FAMILY = {
    "Homoserine_dh": "PF00742",
    "AA_kinase": "PF00696",
    "23ISL": "PF16620",
}


@pytest.fixture(scope="module")
def minifam_profiles(tmp_path_factory):
    out = tmp_path_factory.mktemp("scan") / "minifam.dcp"
    press(MINIFAM, str(out), gencode_id=1, epsilon=0.01)
    _, profiles = read_dcp_profiles(str(out))
    return profiles


@pytest.fixture(scope="module")
def consensus_sequences():
    with open(os.path.join(HERE, "data_consensus.json")) as fp:
        raw = json.load(fp)
    return [Sequence.make(e["id"], e["name"], e["seq"]) for e in raw]


def read_products(path):
    with open(path) as fp:
        header = fp.readline()
        assert header.startswith("sequence\t")
        return [line.rstrip("\n").split("\t") for line in fp]


def test_scan_consensus_hits_own_family(minifam_profiles, consensus_sequences,
                                        tmp_path):
    scanner = Scanner(minifam_profiles, ScanConfig())
    out = scanner.run(consensus_sequences, str(tmp_path / "prod"))
    rows = read_products(out)
    assert rows, "consensus reads must produce hits"
    assert scanner.progress == 100

    by_seq = {}
    for r in rows:
        seq_id, profile, lrt = int(r[0]), r[7], float(r[9])
        by_seq.setdefault(seq_id, []).append((profile, lrt))
    for seq in consensus_sequences:
        fam = FAMILY[seq.name.split("-")[0]]
        assert seq.id in by_seq, f"sequence {seq.id} ({seq.name}) missing"
        best = max(by_seq[seq.id], key=lambda t: t[1])
        assert best[0].startswith(fam), (
            f"seq {seq.id} ({seq.name}): best hit {best} not {fam}")
        assert best[1] > 50.0  # consensus reads score far above threshold


def test_scan_deterministic(minifam_profiles, consensus_sequences, tmp_path):
    seqs = consensus_sequences[:3]
    cfg = ScanConfig(engine="jax")
    out1 = Scanner(minifam_profiles, cfg).run(seqs, str(tmp_path / "p1"))
    out2 = Scanner(minifam_profiles, cfg).run(seqs, str(tmp_path / "p2"))
    assert fletcher16(out1) == fletcher16(out2)
    assert open(out1, "rb").read() == open(out2, "rb").read()


def test_scan_flag_combos_change_products(minifam_profiles,
                                          consensus_sequences, tmp_path):
    seqs = consensus_sequences[:1]
    outs = []
    for mh, h3c in [(True, False), (False, False), (True, True)]:
        cfg = ScanConfig(engine="jax", multi_hits=mh, hmmer3_compat=h3c)
        out = Scanner(minifam_profiles, cfg).run(
            seqs, str(tmp_path / f"p{mh}{h3c}"))
        outs.append(open(out).read())
    # multi-hit wiring and hmmer3-compat change the DP; lrt columns differ
    assert outs[0] != outs[1]


def test_engine_equivalence_oracle(minifam_profiles, consensus_sequences,
                                   tmp_path, oracle_scorer):
    seqs = consensus_sequences[2:3]  # 23ISL (smallest profile hits fast)
    out_o = Scanner(minifam_profiles, scorer=oracle_scorer).run(
        seqs, str(tmp_path / "oracle"))
    out_d = Scanner(minifam_profiles).run(seqs, str(tmp_path / "default"))
    assert open(out_o).read() == open(out_d).read()


def test_bigk_vmem_bucket_equivalence(tmp_path, oracle_scorer):
    """K past 2048 — the kernel's memory-state tier (a 2560-node block)
    and a 4096-node plain bucket — scans to the products of the
    per-window, unpadded oracle."""
    import numpy as np

    from deciphon_tpu.profile import sample_profile
    from deciphon_tpu.scan.scheduler import bucket_nodes
    from deciphon_tpu.scan.sequence import Sequence

    profiles = [sample_profile(seed=81, core_size=2300)]
    rng = np.random.default_rng(13)
    seqs = [Sequence.make(0, "r0", "".join(
        "ACGT"[b] for b in rng.integers(0, 4, size=2000)))]
    out_o = Scanner(profiles, scorer=oracle_scorer).run(
        seqs, str(tmp_path / "oracle"))
    sc = Scanner(profiles)
    out_d = sc.run(seqs, str(tmp_path / "default"))
    assert open(out_o).read() == open(out_d).read()
    assert sc.scorer.buckets[0].kn == 4096
    assert bucket_nodes(2300, "cuda") == 2560


def test_uniform_k_pack_windowed_reads_equivalence(tmp_path, oracle_scorer):
    """Same-K profiles over reads long enough to be windowed (5 knt >
    50*K for K=60): every window of every profile goes to one bucket's
    calls, and the products equal the per-window oracle's."""
    import numpy as np

    from deciphon_tpu.profile import sample_profile
    from deciphon_tpu.scan.sequence import Sequence

    profiles = [sample_profile(seed=70 + i, core_size=60)
                for i in range(3)]
    rng = np.random.default_rng(12)
    seqs = [Sequence.make(i, f"r{i}", "".join(
        "ACGT"[b] for b in rng.integers(0, 4, size=n)))
        for i, n in enumerate((5000, 2400, 900))]
    out_o = Scanner(profiles, scorer=oracle_scorer).run(
        seqs, str(tmp_path / "oracle"))
    sc = Scanner(profiles)
    out_d = sc.run(seqs, str(tmp_path / "default"))
    assert open(out_o).read() == open(out_d).read()
    assert len(sc.scorer.buckets) == 1
    assert sc.metrics.windows_scored > len(seqs) * len(profiles)


def test_scan_with_native_confirmation(minifam_profiles, consensus_sequences,
                                       tmp_path):
    from deciphon_tpu.hmmer.forward import NativeConfirmer
    from deciphon_tpu.hmmfile import read_hmm
    from deciphon_tpu.snap.snap_file import make_snap_archive, read_snap

    confirmer = NativeConfirmer(read_hmm(MINIFAM))
    scanner = Scanner(minifam_profiles, ScanConfig(engine="jax"),
                      confirmer=confirmer.confirm)
    basedir = str(tmp_path / "conf")
    import os

    os.makedirs(basedir)
    out = scanner.run(consensus_sequences[:3], basedir)
    rows = read_products(out)
    assert rows, "confirmed scan must keep the consensus hits"
    for r in rows:
        evalue = float(r[10])
        assert evalue < 1e-5  # consensus reads are overwhelming hits

    dcs = make_snap_archive(basedir, str(tmp_path / "conf.dcs"))
    prods = read_snap(dcs).products
    assert all(p.h3result_blob is not None for p in prods)
    from deciphon_tpu.hmmer.h3result import H3Result

    h3r = H3Result.from_blob(prods[0].h3result_blob)
    assert h3r.nhits == 1


@pytest.mark.slow
def test_products_invariant_to_speculation_depth(tmp_path):
    """spec_depth=1 is the serial reference walk; deeper speculation with
    hit rewinds must produce byte-identical products on a hit-rich
    workload (minifam x consensus reads, every pair hits)."""
    import json

    from deciphon_tpu.io.dcp import read_dcp_profiles
    from deciphon_tpu.scan.pipeline import ScanConfig, Scanner
    from deciphon_tpu.scan.sequence import Sequence

    _, profiles = read_dcp_profiles(
        "/root/reference/control/tests/files/minifam.dcp")
    cons = json.load(open("tests/data_consensus.json"))
    # duplicate reads so cursors hold multi-window chains worth rewinding
    seqs = [Sequence.make(i, f"{s['name']}.{i}", s["seq"] * 3)
            for i, s in enumerate(cons * 2)]

    outs = []
    for depth in (1, 64):
        cfg = ScanConfig(engine="jax", spec_depth=depth)
        out = Scanner(profiles, cfg).run(seqs, str(tmp_path / f"d{depth}"))
        outs.append(open(out).read())
    assert outs[0] == outs[1]
    assert outs[0].count("\n") > len(seqs)  # real hit-rich products
