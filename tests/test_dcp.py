"""Press -> .dcp -> reload round-trip, byte-size oracle, and reference
fixture interoperability (the externally pressed minifam.dcp)."""

import os

import numpy as np
import pytest

from deciphon_tpu.hmmfile import read_hmm
from deciphon_tpu.io import mpack
from deciphon_tpu.io.dcp import (
    AMINO_SYMBOLS,
    DNA_SYMBOLS,
    DcpReader,
    TYPEID_AMINO,
    TYPEID_DNA,
    _pack_abc,
    read_dcp_profiles,
)
from deciphon_tpu.press import press
from deciphon_tpu.profile import press_profile

MINIFAM = "/root/reference/c-core/minifam.hmm"
# Reference-pressed database shipped in the reference tree (pressed by the
# real c-core + imm): the external oracle for both format and table math.
REFERENCE_DCP = "/root/reference/control/tests/files/minifam.dcp"
# c-core/test_press.c:27 — exact byte size of a fresh minifam press.
REFERENCE_PRESS_SIZE = 3_609_858


@pytest.fixture(scope="module")
def minifam_dcp(tmp_path_factory):
    out = tmp_path_factory.mktemp("dcp") / "minifam.dcp"
    seen = []
    press(MINIFAM, str(out), gencode_id=1, epsilon=0.01,
          progress=lambda d, t: seen.append((d, t)))
    assert seen[-1] == (3, 3)
    return str(out)


def test_press_byte_size_matches_reference_oracle(minifam_dcp):
    assert os.path.getsize(minifam_dcp) == REFERENCE_PRESS_SIZE


def test_press_writes_three_profiles(minifam_dcp):
    with DcpReader(minifam_dcp) as r:
        assert r.num_proteins == 3
        assert r.header.epsilon == pytest.approx(0.01)
        assert r.header.entry_dist == 2  # occupancy
        assert r.header.abc == "ACGT"
        assert r.header.amino == "ACDEFGHIKLMNPQRSTVWY"
        assert r.header.has_ga  # minifam profiles all carry GA
        assert len(r.header.protein_sizes) == 3


def test_abc_blobs_byte_exact_vs_reference():
    """The imm abc pack layout (symbols/idx/any_symbol_id/typeid) is
    reproduced byte-for-byte — both blobs appear verbatim in the
    reference-pressed fixture."""
    data = open(REFERENCE_DCP, "rb").read()
    pk = mpack.Packer(use_single_float=True)
    assert _pack_abc(pk, DNA_SYMBOLS, TYPEID_DNA) in data
    assert _pack_abc(pk, AMINO_SYMBOLS, TYPEID_AMINO) in data


def test_reads_reference_pressed_fixture():
    """Open the reference's own pressed .dcp (older imm ExtType layout)."""
    hdr, profiles = read_dcp_profiles(REFERENCE_DCP)
    assert hdr.abc == "ACGT"
    assert hdr.amino == "ACDEFGHIKLMNPQRSTVWY"
    assert hdr.has_ga
    assert hdr.entry_dist == 2
    assert hdr.epsilon == pytest.approx(0.01)
    assert [p.accession for p in profiles] == [
        "PF00742.20", "PF00696.29", "PF16620.6"]
    assert [p.core_size for p in profiles] == [173, 241, 162]


def test_reference_fixture_tables_match_fresh_press():
    """Our press math agrees with the real imm/c-core output to f32
    rounding (<= 8e-6) on every table; transitions agree exactly."""
    _, ref_profiles = read_dcp_profiles(REFERENCE_DCP)
    hmms = read_hmm(MINIFAM)
    for ref, hmm in zip(ref_profiles, hmms):
        ours = press_profile(hmm, 1, 0.01)
        assert ref.core_size == ours.core_size
        assert ref.consensus == ours.consensus
        np.testing.assert_allclose(
            ref.match_emission, ours.match_emission, atol=8e-6)
        np.testing.assert_allclose(
            ref.null_emission, ours.null_emission, atol=8e-6)
        np.testing.assert_allclose(
            ref.bg_emission, ours.bg_emission, atol=8e-6)
        np.testing.assert_allclose(ref.BMk, ours.BMk, atol=8e-6)
        # disk stores model trans rows 1..K (protein.c:99 row shift);
        # row 0 (BEGIN) is not on disk.
        rt, ot = ref.trans[1:], ours.trans[1:]
        assert np.array_equal(np.isfinite(rt), np.isfinite(ot))
        mask = np.isfinite(rt)
        np.testing.assert_allclose(rt[mask], ot[mask], atol=1e-6)


def test_roundtrip_matches_fresh_press(minifam_dcp):
    header, profiles = read_dcp_profiles(minifam_dcp)
    hmms = read_hmm(MINIFAM)
    assert [p.accession for p in profiles] == [h.accession for h in hmms]
    for disk, hmm in zip(profiles, hmms):
        fresh = press_profile(hmm, 1, 0.01)
        assert disk.core_size == fresh.core_size
        assert disk.consensus == fresh.consensus
        # the BEGIN row (model trans[0]) is not stored on disk
        np.testing.assert_array_equal(disk.trans[1:], fresh.trans[1:])
        np.testing.assert_array_equal(disk.BMk, fresh.BMk)
        np.testing.assert_array_equal(disk.match_emission,
                                      fresh.match_emission)
        np.testing.assert_array_equal(disk.null_emission,
                                      fresh.null_emission)
        np.testing.assert_array_equal(disk.bg_emission, fresh.bg_emission)
        # codon cubes go through the (5,5,5) marginal form on disk
        np.testing.assert_allclose(disk.match_codon_lprobs,
                                   fresh.match_codon_lprobs, atol=1e-6)


def test_random_access_matches_sequential(minifam_dcp):
    with DcpReader(minifam_dcp) as r:
        last = r.read_profile(r.num_proteins - 1)
        first = r.read_profile(0)
        seq = list(r)
    assert first.accession == seq[0].accession
    assert last.accession == seq[-1].accession
    np.testing.assert_array_equal(last.match_emission,
                                  seq[-1].match_emission)


def test_minifam_profiles_sane(minifam_dcp):
    _, profiles = read_dcp_profiles(minifam_dcp)
    for p in profiles:
        # emission tables are log-probs: logsumexp over each duration class
        # sums to 1 overall
        total = np.logaddexp.reduce(
            p.match_emission[0].astype(np.float64))
        assert total == pytest.approx(0.0, abs=1e-4)
        assert np.all(p.BMk <= 0.0)


def test_chunked_writer_byte_identical(minifam_dcp, tmp_path):
    """The rotating temp-chunk writer (reference 32 x 4 GB design,
    database_writer.c:14,201-207): a split size small enough to force
    one chunk PER PROTEIN must produce a byte-identical .dcp, with
    bounded per-chunk staging."""
    from deciphon_tpu.io.dcp import DcpFormatError, DcpWriter

    _, profiles = read_dcp_profiles(minifam_dcp)

    def write(path, split):
        w = DcpWriter(str(path), entry_dist=1, epsilon=0.01,
                      split_size=split)
        w.set_has_ga(all(p.has_ga for p in profiles))
        nchunks = 1
        for p in profiles:
            w.pack_profile(p)
            nchunks = len(w._chunk_paths)
        w.close()
        return nchunks

    plain = tmp_path / "plain.dcp"
    chunked = tmp_path / "chunked.dcp"
    assert write(plain, None) == 1
    assert write(chunked, 1) >= len(profiles)  # rotated per protein
    assert plain.read_bytes() == chunked.read_bytes()
    # the rotated write still round-trips
    _, back = read_dcp_profiles(str(chunked))
    assert [p.accession for p in back] == [p.accession for p in profiles]

    # chunk-count ceiling errors loudly instead of silently overflowing
    w = DcpWriter(str(tmp_path / "over.dcp"), 1, 0.01, split_size=1)
    w.MAX_CHUNKS = 3
    w.pack_profile(profiles[0])
    w.pack_profile(profiles[1])
    with pytest.raises(DcpFormatError, match="chunks"):
        w.pack_profile(profiles[2])
