"""Device-parallel scan on the virtual CPU mesh: the pair dimension of
every phase-1 call sharded over the devices must leave the products
byte-identical (the reference's thread-count contract,
python-core/tests/test_scan.py:102-104, at device level)."""

import jax
import pytest

from deciphon_tpu.scan.pipeline import Scanner


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """Seeded profiles and reads with planted domains, so phase 2 runs."""
    import chip_smoke

    tmp = str(tmp_path_factory.mktemp("md"))
    profiles, hmms = chip_smoke.build_database(
        3, tmp, ks=[25, 40, 55, 58, 60, 62, 64, 66, 90])
    reads, _ = chip_smoke.make_reads(profiles, hmms, 3, planted_ks=(60,),
                                     read_len=1200, long_read_len=3500)
    return profiles, reads


def _scan(profiles, reads, path, devices=None):
    sc = Scanner(profiles, devices=devices)
    out = sc.run(reads, str(path))
    return open(out).read(), sc


def test_multidevice_mini_e2e(workload, tmp_path):
    """Eight devices against one: speculation, phase 2 and product
    writing all live, products byte for byte."""
    profiles, reads = workload
    assert len(jax.devices()) >= 8
    single, sc1 = _scan(profiles, reads, tmp_path / "single")
    multi, sc8 = _scan(profiles, reads, tmp_path / "multi", jax.devices()[:8])
    assert sc8.scorer.mesh is not None and sc1.scorer.mesh is None
    assert sc1.metrics.survivors > 0, "the workload must reach phase 2"
    assert multi == single


def test_multidevice_scorer_subset_of_devices(workload, tmp_path):
    """A 3-device subset (pair counts padded to a multiple of 3) over the
    windowed long read matches one device."""
    profiles, reads = workload
    single, _ = _scan(profiles, reads[1:], tmp_path / "single")
    multi, sc = _scan(profiles, reads[1:], tmp_path / "multi",
                      jax.devices()[:3])
    assert sc.scorer.mesh.devices.size == 3
    assert sc.metrics.windows_scored > len(profiles)
    assert multi == single
