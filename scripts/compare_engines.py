"""Time the scan end to end with the phase-1 kernel and with plain XLA.

    python scripts/compare_engines.py [--out chiprun_out/engines.json]

On one GPU: the database and reads of chip_smoke.py (500 Pfam-shaped
profiles plus one of K=4608; planted 10 knt reads and a 100 knt read),
scanned through Scanner with engine "cuda" (the Hopper kernel) and "jax"
(the lax.scan engine XLA compiles).  Each engine first runs once cold
(compiles included), then warm in the order cuda, jax, jax, cuda.  Prints
and writes the walls, the phase walls of each run (phase 2's share of the
wall among them), the card's name and power limit, and whether the
products of all runs are byte-identical.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    import chip_smoke
    from deciphon_tpu.scan.pipeline import ScanConfig, Scanner
    from deciphon_tpu.utils.jaxcache import enable_compilation_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: {devs}")
    enable_compilation_cache()
    card = chip_smoke.card_line()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        profiles, hmms = chip_smoke.build_database(args.seed, tmp)
        reads, _ = chip_smoke.make_reads(profiles, hmms, args.seed)
        scanners = {e: Scanner(profiles, ScanConfig(engine=e))
                    for e in ("cuda", "jax")}
        for i, (engine, kind) in enumerate([
                ("cuda", "cold"), ("jax", "cold"), ("cuda", "warm"),
                ("jax", "warm"), ("jax", "warm"), ("cuda", "warm")]):
            sc = scanners[engine]
            t0 = time.perf_counter()
            out = sc.run(reads, os.path.join(tmp, f"run{i}"))
            wall = time.perf_counter() - t0
            m = sc.metrics
            p2 = sum(v for k, v in m.walls.items() if k.startswith("phase2"))
            runs.append({
                "engine": engine, "kind": kind, "wall_s": wall,
                "phase2_s": p2, "phase2_share": p2 / wall,
                "windows": m.windows_scored, "cells": m.cells,
                "survivors": m.survivors, "products": m.products,
                "walls": dict(sorted(m.walls.items())),
                "products_tsv": open(out, "rb").read()})
            print(f"{engine} {kind}: wall_s={wall:.3f} phase2_s={p2:.3f} "
                  f"windows={m.windows_scored} survivors={m.survivors}",
                  flush=True)
    same = len({r.pop("products_tsv") for r in runs}) == 1
    result = {"card": card, "device_kind": devs[0].device_kind,
              "reads": len(reads), "nt": sum(r.size for r in reads),
              "profiles": len(profiles), "products_identical": same,
              "runs": runs}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fp:
            fp.write(text)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
