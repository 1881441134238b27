"""Sequence preparation: encoding and fragment-code precompute.

Design: the per-(position, duration) emission "code" lookups the
reference does on the fly (imm_eseq_get, c-core/thread.c:92-96) are
precomputed host-side into a dense (L, 5) int32 array once per sequence, so
the device DP is pure gathers with static shapes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..alphabet import prepare_sequence
from ..frame import FRAG_OFFSETS


def frag_codes_ending(seq: np.ndarray) -> np.ndarray:
    """codes[l-1, t-1] = code of the length-t fragment *ending* at position l.

    seq: (L,) int array of base indices.  Entries with t > l are 0 (callers
    mask them by duration validity).  This is the layout consumed by
    ops.viterbi_jax (codes row l-1 feeds DP position l).
    """
    L = len(seq)
    s = seq.astype(np.int64)
    codes = np.zeros((L, 5), dtype=np.int32)
    val = np.zeros(L, dtype=np.int64)  # base-4 value of fragment ending at l
    for t in range(1, 6):
        # fragment [l-t, l) value: val_new[l] = val_old[l-1 shifted] * ...
        if t == 1:
            val = s.copy()
        else:
            # value of seq[l-t:l] = value of seq[l-t:l-1] * 4 + seq[l-1]
            prev = np.zeros(L, dtype=np.int64)
            prev[t - 1 :] = val[t - 2 : L - 1]
            val = prev * 4 + s
        idx = np.arange(L)
        valid = idx >= t - 1
        codes[valid, t - 1] = FRAG_OFFSETS[t - 1] + val[valid]
    return codes


@dataclass
class Sequence:
    """A prepared query sequence."""

    id: int
    name: str
    data: str  # uppercase, disambiguated
    symbols: np.ndarray  # (L,) int8
    codes: np.ndarray  # (L, 5) int32 fragment codes (ending layout)

    @property
    def size(self) -> int:
        return len(self.symbols)

    @classmethod
    def make(cls, id: int, name: str, raw: str) -> "Sequence":
        symbols = prepare_sequence(raw)
        from ..alphabet import disambiguate

        data = disambiguate(raw)
        return cls(id=id, name=name, data=data, symbols=symbols,
                   codes=frag_codes_ending(symbols))

    def window_codes(self, start: int, stop: int) -> np.ndarray:
        """Codes for the window [start, stop): (stop-start, 5).

        Row l-1 = codes of fragments ending at window position l; fragments
        must not reach before the window start, so rows with t > l are
        garbage there (masked by the engine's duration-validity check).
        Recomputed cheaply from the window slice to keep exact semantics.
        """
        return frag_codes_ending(self.symbols[start:stop])
