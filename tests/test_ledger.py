"""Device-memory capacity ledger: resident-vs-streamed table planning and
the streamed scan path (the database-exceeds-device tier,
c-core/database_writer.c:14 / protein_reader.c:77-101 design point)."""

from deciphon_tpu.scan.scheduler import (HBMLedger, PairScorer,
                                         device_table_budget)


def test_ledger_plan_partition():
    led = HBMLedger(100)
    flags = led.plan([60, 50, 30, 10])
    # biggest first: 60 fits (40 left), 50 does not, 30 fits (10 left),
    # 10 fits (0 left)
    assert flags == [False, True, False, False]
    assert led.resident_bytes == 100
    assert led.streamed_bytes == 50


def test_ledger_single_oversized_bucket_streams():
    led = HBMLedger(10)
    flags = led.plan([100])
    assert flags == [True]  # streams instead of erroring or OOMing


def test_ledger_deterministic_tie_break():
    led = HBMLedger(25)
    assert led.plan([10, 10, 10]) == [False, False, True]


def test_device_table_budget_env(monkeypatch):
    monkeypatch.setenv("DECIPHON_HBM_BUDGET", "12345")
    assert device_table_budget() == 12345


def test_streamed_scan_products_identical(tmp_path):
    """A budget far below the table mass forces EVERY bucket to stream;
    products must match the fully resident scan byte for byte."""
    import chip_smoke
    from deciphon_tpu.scan.pipeline import Scanner

    profiles, hmms = chip_smoke.build_database(
        4, str(tmp_path), ks=[20, 55, 58, 60, 62, 64, 66, 130])
    reads, _ = chip_smoke.make_reads(profiles, hmms, 4, planted_ks=(60,),
                                     read_len=1000, long_read_len=1500)

    outs = {}
    for label, budget in (("resident", None), ("streamed", 1)):
        sc = Scanner(
            profiles,
            scorer=lambda costs, budget=budget: PairScorer(
                costs, backend="jax", hbm_budget=budget))
        if label == "streamed":
            assert all(b.stream for b in sc.scorer.buckets)
            assert sc.scorer.ledger.streamed  # the ledger engaged
        else:
            assert not any(b.stream for b in sc.scorer.buckets)
        out = sc.run(reads, str(tmp_path / label))
        outs[label] = open(out).read()
    assert outs["resident"] == outs["streamed"]
    assert len(outs["resident"].splitlines()) > 1
