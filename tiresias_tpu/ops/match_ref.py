"""Pure-Python behavioral oracle of the reference's search semantics.

A literal simulation of ``fp_search_fingerprint_info``
(/root/reference/src/fp_handler.c:207-408) — the per-frame SQL loop —
against a list-of-arrays fingerprint DB. It exists solely to cross-validate
the device matchers (:mod:`tiresias_tpu.ops.match_jax` / ``match_pallas``) in
tests; it is deliberately slow and obvious.

Semantics replicated (see PARITY.md §3):
  * query ``max1`` truncated toward zero (C ``(int)`` cast, fp_handler.c:290);
    ``max2`` used raw (:321).
  * band filter compares the truncated ``max1`` against
    ``10*log10(freq_ignore_*)`` and skips the *frame* (:293-306); for
    ``max2`` the same check merely drops the max2 *condition* (:324-337).
  * inclusive tolerance band ``db >= q-tol AND db <= q+tol`` (:308-314).
  * one vote per query frame per audio (INSERT … GROUP BY audio_uuid, :353).
  * result: top-1 audio by votes; ``frame_count`` counts *all* query frames
    (:286,403); ``match_count`` = winner's votes (:404).
  * no context filtering in the scan (:308-314 — quirk, PARITY.md §3.6).

Not replicated: the reference interpolates bounds into SQL with ``%f`` (6
decimal places), quantizing band edges by <5e-7 — a measure-zero effect
documented in PARITY.md, not carried over.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from tiresias_tpu.config import DEF_SEARCH_TOLERANCE


@dataclasses.dataclass
class RefSearchResult:
    votes: np.ndarray  # int64 [n_audios]
    best_index: int | None  # None when nothing matched
    frame_count: int

    @property
    def match_count(self) -> int:
        return 0 if self.best_index is None else int(self.votes[self.best_index])


def search_reference(
    db: list[np.ndarray],
    query: np.ndarray,
    coefs: int = 1,
    tolerance: float = DEF_SEARCH_TOLERANCE,
    freq_ignore_low: int = -1,
    freq_ignore_high: int = -1,
    trunc_coef1: bool = True,
) -> RefSearchResult:
    """Simulate the reference search.

    Args:
      db: per-audio ``[T_a, n_coefs]`` stored fingerprint arrays.
      query: ``[F, n_coefs]`` query fingerprint.
      coefs / tolerance / freq_ignore_*: as the reference arguments.
      trunc_coef1: False disables the (int) cast — PARITY.md D8 extension
        (the oracle supports it so both modes can be cross-validated).
    """
    # the reference clamps to its 2 stored coefs (fp_handler.c:247-250);
    # more stored coefficients are a documented extension — but never more
    # than the narrowest stored/query fingerprint provides
    widths = [query.shape[1]] + [d.shape[1] for d in db]
    if coefs < 1 or coefs > min(widths):
        raise ValueError(f"coefs must be in [1, {min(widths)}]")
    tol = tolerance
    if tol < 0:
        tol = DEF_SEARCH_TOLERANCE  # fp_handler.c:252-256

    lo_thr = 10.0 * math.log10(freq_ignore_low) if freq_ignore_low > 0 else None
    hi_thr = 10.0 * math.log10(freq_ignore_high) if freq_ignore_high > 0 else None

    votes = np.zeros(len(db), dtype=np.int64)
    frame_count = len(query)
    for f in range(frame_count):
        # (int) cast truncates toward zero (fp_handler.c:290)
        q0 = float(int(query[f, 0])) if trunc_coef1 else float(query[f, 0])
        if lo_thr is not None and q0 < lo_thr:
            continue  # frame skipped entirely
        if hi_thr is not None and q0 > hi_thr:
            continue
        conds: list[tuple[int, float]] = [(0, q0)]
        for c in range(1, coefs):
            qc = float(query[f, c])
            if c == 1:
                # the reference's coef-2 band quirk: out-of-band max2 merely
                # drops the max2 condition (fp_handler.c:324-337)
                if lo_thr is not None and qc < lo_thr:
                    continue
                if hi_thr is not None and qc > hi_thr:
                    continue
            conds.append((c, qc))
        for a, stored in enumerate(db):
            if len(stored) == 0:
                continue
            ok = np.ones(len(stored), dtype=bool)
            for c, qv in conds:
                ok &= (stored[:, c] >= qv - tol) & (stored[:, c] <= qv + tol)
            if ok.any():
                votes[a] += 1  # GROUP BY audio_uuid: one vote per frame

    if votes.max(initial=0) <= 0:
        return RefSearchResult(votes=votes, best_index=None, frame_count=frame_count)
    best = int(np.argmax(votes))  # deterministic lowest-index tiebreak (PARITY.md D5)
    return RefSearchResult(votes=votes, best_index=best, frame_count=frame_count)
