"""The in-repo MessagePack codec (io/mpack.py): the same bytes as the
`msgpack` package where it is installed, and .dcp / h3result round trips."""

import io

import numpy as np
import pytest

from deciphon_tpu.io import mpack

CASES = [
    None, True, False,
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.0, -1.5, 3.141592653589793, 1e300, float("inf"),
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000,
    b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000,
    mpack.ExtType(0, bytes(range(94))), mpack.ExtType(8, b"abcd"),
    mpack.ExtType(6, b"x"), mpack.ExtType(127, b"y" * 16),
    mpack.ExtType(5, b"z" * 300), mpack.ExtType(1, b"w" * 70000),
    [], list(range(15)), list(range(16)), [0.5] * 70000,
    {}, {f"k{i}": i for i in range(15)}, {f"k{i}": [i] for i in range(16)},
    {"h3result": {"stats": [1.0, 2, "x", None], "tophits": [[], 0, False]}},
    {1: "int key", "nested": {"a": [b"\x00", -7, 2.5]}},
]


def _to_msgpack(msgpack, o):
    if isinstance(o, mpack.ExtType):
        return msgpack.ExtType(o.code, o.data)
    if isinstance(o, list):
        return [_to_msgpack(msgpack, v) for v in o]
    if isinstance(o, dict):
        return {k: _to_msgpack(msgpack, v) for k, v in o.items()}
    return o


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("i", range(len(CASES)))
def test_same_bytes_as_msgpack(i, single):
    msgpack = pytest.importorskip("msgpack")
    obj = CASES[i]
    ours = mpack.packb(obj, use_single_float=single)
    theirs = msgpack.Packer(use_single_float=single).pack(
        _to_msgpack(msgpack, obj))
    assert ours == theirs
    back = msgpack.unpackb(theirs, strict_map_key=False)
    assert mpack.unpackb(ours) == _from_msgpack(msgpack, back)


def _from_msgpack(msgpack, o):
    if isinstance(o, msgpack.ExtType):
        return mpack.ExtType(o.code, o.data)
    if isinstance(o, list):
        return [_from_msgpack(msgpack, v) for v in o]
    if isinstance(o, dict):
        return {k: _from_msgpack(msgpack, v) for k, v in o.items()}
    return o


def test_stream_reads_across_chunks_and_tells():
    blobs = [mpack.packb(o, use_single_float=True) for o in CASES]
    u = mpack.Unpacker(io.BytesIO(b"".join(blobs)))
    u.CHUNK = 7  # force reads that split every object
    pos = 0
    for blob in blobs:
        assert u.unpack() == mpack.unpackb(blob)
        pos += len(blob)
        assert u.tell() == pos
    pairs = mpack.Unpacker(mpack.packb({"b": 1, "a": 2}),
                           object_pairs_hook=lambda ps: ps).unpack()
    assert pairs == [("b", 1), ("a", 2)]


def test_float32_arrays_decode_exactly():
    vals = np.random.default_rng(0).standard_normal(129).astype(np.float32)
    blob = mpack.packb([float(v) for v in vals], use_single_float=True)
    assert np.array_equal(np.asarray(mpack.unpackb(blob), np.float32), vals)


@pytest.mark.parametrize("blob", [b"", b"\x92\x01", b"\xc1", b"\xd9\x05ab",
                                  b"\x01\x02"])
def test_malformed_raises(blob):
    with pytest.raises(mpack.FormatError):
        mpack.unpackb(blob)


def test_dcp_round_trip(tmp_path):
    """DcpWriter -> read_dcp_profiles gives the profiles back, and
    rewriting what was read gives the same bytes."""
    from deciphon_tpu.io.dcp import DcpWriter, read_dcp_profiles
    from deciphon_tpu.profile import sample_profile

    profiles = [sample_profile(i, k) for i, k in enumerate((3, 40, 130))]
    paths = []
    for name, profs in (("a", profiles), ("b", None)):
        path = str(tmp_path / f"{name}.dcp")
        w = DcpWriter(path, entry_dist=2, epsilon=0.1)
        for p in profs if profs is not None else back:
            w.pack_profile(p)
        w.close()
        hdr, back = read_dcp_profiles(path)
        paths.append(path)
    assert hdr.epsilon == pytest.approx(0.1) and hdr.abc == "ACGT"
    for a, b in zip(profiles, back):
        assert a.core_size == b.core_size and a.accession == b.accession
        np.testing.assert_array_equal(a.match_emission, b.match_emission)
        np.testing.assert_array_equal(a.null_emission, b.null_emission)
        np.testing.assert_array_equal(a.BMk, b.BMk)
        np.testing.assert_array_equal(a.trans[1:], b.trans[1:])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_h3result_round_trip():
    from deciphon_tpu.hmmer.h3result import H3Result

    h3r = H3Result.single_hit(name="n", acc="PF1", score=42.5, lnP=-30.25,
                              Z=7.0, qlen=120, seqlen=118)
    back = H3Result.from_blob(h3r.to_blob())
    assert back.nhits == 1 and back.Z == 7.0
    assert back.hits[0].score == pytest.approx(42.5)
    assert back.to_blob() == h3r.to_blob()
