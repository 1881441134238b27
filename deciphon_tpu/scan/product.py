"""Product (hit) accumulation and products.tsv writing.

Parity: c-core/product.c (header + shard merge), product_thread.c (row
format), product_line.c.  Row format:

  sequence  window  window_start  window_stop  hit  hit_start  hit_stop
  profile  abc  lrt(%.1f)  evalue(%.2g)  match

match string: ';'-joined "frag,STATE,codon,amino" per path step
(codon/amino empty for mute states).

Line order matches the reference's merged per-thread shards: partitions are
contiguous protein ranges and each thread walks proteins, then sequences,
then windows — i.e. global order (protein_idx, sequence, window) regardless
of thread count (the reference's determinism contract,
python-core/tests/test_scan.py:102-104).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

HEADER = ("sequence\twindow\twindow_start\twindow_stop\thit\thit_start\t"
          "hit_stop\tprofile\tabc\tlrt\tevalue\tmatch\n")


def format_evalue(logevalue: float) -> str:
    """%.2g of exp(logevalue) (product_thread.c:63)."""
    return "%.2g" % math.exp(logevalue)


def format_lrt(lrt: float) -> str:
    return "%.1f" % lrt


@dataclass
class MatchStep:
    frag: str  # raw nucleotides of this step (may be "")
    state: str  # state name, e.g. "M12", "I3", "B"
    codon: str  # "" for mute states
    amino: str  # "" for mute states

    def render(self) -> str:
        return f"{self.frag},{self.state},{self.codon},{self.amino}"


@dataclass
class ProductLine:
    sequence: int
    window: int
    window_start: int
    window_stop: int
    hit: int
    hit_start: int
    hit_stop: int
    profile: str
    abc: str
    lrt: float
    logevalue: float
    # Each step is either a MatchStep or an already-rendered
    # "frag,STATE,codon,amino" string — the scan pipeline emits rendered
    # strings directly (per-step object construction was a measured
    # survivor-heavy hot spot).
    steps: list = field(default_factory=list)

    def render(self) -> str:
        cols = [
            str(self.sequence), str(self.window), str(self.window_start),
            str(self.window_stop), str(self.hit), str(self.hit_start),
            str(self.hit_stop), self.profile, self.abc,
            format_lrt(self.lrt), format_evalue(self.logevalue),
            ";".join(s if isinstance(s, str) else s.render()
                     for s in self.steps),
        ]
        return "\t".join(cols) + "\n"


class ProductWriter:
    """Collects lines plus optional h3r blobs; writes the product directory.

    Directory layout (c-core/product.c:15-31, product_thread.c:81-110):
      <dir>/products.tsv
      <dir>/hmmer/<seq>/<window>/<hit>/<profile>.h3r

    Checkpointing (an addition of this build; the reference has no in-flight
    scan durability, SURVEY.md §5): `journal_line` appends each product to
    <dir>/.scan_checkpoint.jsonl as it is produced, and `load_checkpoint`
    replays it, so an interrupted scan resumes without rescoring finished
    (profile, sequence) pairs.
    """

    CHECKPOINT = ".scan_checkpoint.jsonl"

    def __init__(self, dirname: str):
        self.dirname = dirname
        self.lines: list[ProductLine] = []
        self._orders: list[tuple] = []
        self._journal_fp = None

    def add(self, line: ProductLine, order: tuple | None = None) -> None:
        self.lines.append(line)
        self._orders.append(order if order is not None
                            else (0, line.sequence, line.window))

    def sort_lines(self) -> None:
        """Restore the reference's deterministic (protein, sequence,
        window) order regardless of batch completion order."""
        paired = sorted(zip(self._orders, range(len(self.lines))))
        self.lines = [self.lines[i] for _, i in paired]
        self._orders = [o for o, _ in paired]

    def add_h3r(self, line: ProductLine, blob: bytes) -> None:
        d = os.path.join(self.dirname, "hmmer", str(line.sequence),
                         str(line.window), str(line.hit))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{line.profile}.h3r"), "wb") as fp:
            fp.write(blob)

    def close(self) -> str:
        os.makedirs(self.dirname, exist_ok=True)
        os.makedirs(os.path.join(self.dirname, "hmmer"), exist_ok=True)
        path = os.path.join(self.dirname, "products.tsv")
        with open(path, "w") as fp:
            fp.write(HEADER)
            for line in self.lines:
                fp.write(line.render())
        if self._journal_fp is not None:
            self._journal_fp.close()
            self._journal_fp = None
        ckpt = os.path.join(self.dirname, self.CHECKPOINT)
        if os.path.exists(ckpt):
            os.unlink(ckpt)
        return path

    # -- checkpoint / resume -------------------------------------------
    def journal(self, record: dict) -> None:
        import json

        if self._journal_fp is None:
            os.makedirs(self.dirname, exist_ok=True)
            self._journal_fp = open(
                os.path.join(self.dirname, self.CHECKPOINT), "a")
        self._journal_fp.write(json.dumps(record) + "\n")
        self._journal_fp.flush()

    def journal_line(self, line: ProductLine, order: tuple,
                     pair: tuple[int, int]) -> None:
        self.journal({
            "kind": "line", "order": list(order), "pair": list(pair),
            "fields": {
                "sequence": line.sequence, "window": line.window,
                "window_start": line.window_start,
                "window_stop": line.window_stop, "hit": line.hit,
                "hit_start": line.hit_start, "hit_stop": line.hit_stop,
                "profile": line.profile, "abc": line.abc, "lrt": line.lrt,
                "logevalue": line.logevalue,
                "steps": [s if isinstance(s, str) else s.render()
                          for s in line.steps],
            }})

    def journal_pair_done(self, p_idx: int, s_idx: int) -> None:
        self.journal({"kind": "pair_done", "pair": [p_idx, s_idx]})

    def load_checkpoint(self) -> set[tuple[int, int]]:
        """Replay a previous run's journal; returns completed pairs."""
        import json

        path = os.path.join(self.dirname, self.CHECKPOINT)
        done: set[tuple[int, int]] = set()
        if not os.path.exists(path):
            return done
        recorded: list[tuple[tuple, tuple, ProductLine]] = []
        with open(path) as fp:
            for raw in fp:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    rec = json.loads(raw)
                except ValueError:
                    continue  # torn tail write
                if rec["kind"] == "line":
                    f = rec["fields"]
                    steps = [MatchStep(*s.split(",")) for s in f.pop("steps")]
                    recorded.append((tuple(rec["pair"]), tuple(rec["order"]),
                                     ProductLine(steps=steps, **f)))
                elif rec["kind"] == "pair_done":
                    done.add(tuple(rec["pair"]))
        # keep only lines of completed pairs; incomplete pairs rescan fully
        for pair, order, line in recorded:
            if pair in done:
                self.add(line, order=order)
        return done


def fletcher16(path: str) -> int:
    """Checksum oracle used by the reference tests (c-core/fs.c:157-191)."""
    s1, s2 = 0, 0
    with open(path, "rb") as fp:
        while True:
            chunk = fp.read(5802)
            if not chunk:
                break
            for b in chunk:
                s1 = (s1 + b) % 255
                s2 = (s2 + s1) % 255
    return (s2 << 8) | s1
