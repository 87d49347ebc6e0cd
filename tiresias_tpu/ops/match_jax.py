"""Batched JAX/XLA tolerance-vote matcher (the plain XLA form).

Replacement for the reference's per-frame SQLite range-scan loop
(/root/reference/src/fp_handler.c:287-373): the fingerprint DB lives in HBM
as a padded matrix ``[n_audios, max_frames, n_coefs]`` with a validity mask,
and a whole batch of queries is matched in one jitted computation:

    hit[b, f, a]  = ∃t: valid[a,t] ∧ |q0[b,f] − db[a,t,0]| ≤ tol
                         ∧ (use2[b,f] ⇒ |q1[b,f] − db[a,t,1]| ≤ tol)
    votes[b, a]   = Σ_f active[b,f] ∧ hit[b,f,a]
    best[b]       = argmax_a votes[b,a]   (first max = lowest index)

Query-side preprocessing (int truncation of max1, band-filter frame drops,
per-frame max2-condition drops) matches the reference exactly — see
:func:`prepare_query` and PARITY.md §3.

The audio axis is processed in blocks via ``lax.map`` so peak memory stays
at ``B·F·A_block·T`` booleans regardless of DB size; XLA fuses the
broadcast-compare-reduce so nothing of that size is materialised. The
Triton kernels of the same votes live in :mod:`tiresias_tpu.ops.match_pallas`;
the sharded multi-device driver in :mod:`tiresias_tpu.parallel.sharding`.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from tiresias_tpu.config import DEF_SEARCH_TOLERANCE

AUDIO_BLOCK = 128
OFFSET_BLOCK = 256  # aligned-voting offsets per gather (bounds peak memory)


def band_thresholds(freq_ignore_low: int, freq_ignore_high: int) -> tuple[float, float]:
    """Reference band filter thresholds in the fingerprint's log domain.

    Disabled sides become ±inf so comparisons are trivially true.
    (/root/reference/src/fp_handler.c:293-306)
    """
    lo = 10.0 * math.log10(freq_ignore_low) if freq_ignore_low > 0 else -np.inf
    hi = 10.0 * math.log10(freq_ignore_high) if freq_ignore_high > 0 else np.inf
    return lo, hi


def prepare_query(
    query: np.ndarray | jax.Array,
    n_frames: np.ndarray | jax.Array | None,
    freq_ignore_low: int = -1,
    freq_ignore_high: int = -1,
    trunc_coef1: bool = True,
):
    """Reference query-side preprocessing, batched.

    Args:
      query: ``[B, F, C]`` fingerprint values (C ≥ 1).
      n_frames: ``[B]`` true frame counts (None → all F frames valid).
      trunc_coef1: replicate the reference's C ``(int)`` cast of the query's
        max1 (/root/reference/src/fp_handler.c:290). ``False`` is the
        documented high-accuracy extension (PARITY.md D8) — the cast loses
        ~1 unit of precision in a domain where distinct audio differs by
        ~0.1, making small-tolerance self-match impossible.
    Returns:
      (q [B, F, C] with q[...,0] int-truncated when trunc_coef1,
       active [B, F] bool, use2 [B, F] bool).
    """
    q = jnp.asarray(query, dtype=jnp.float32)
    b, f, c = q.shape
    lo, hi = band_thresholds(freq_ignore_low, freq_ignore_high)
    q0 = jnp.trunc(q[..., 0]) if trunc_coef1 else q[..., 0]
    q = q.at[..., 0].set(q0)
    valid = (
        jnp.ones((b, f), dtype=bool)
        if n_frames is None
        else jnp.arange(f)[None, :] < jnp.asarray(n_frames)[:, None]
    )
    active = valid & (q0 >= lo) & (q0 <= hi)
    if c >= 2:
        q1 = q[..., 1]
        use2 = (q1 >= lo) & (q1 <= hi)
    else:
        use2 = jnp.zeros((b, f), dtype=bool)
    return q, active, use2


@functools.partial(
    jax.jit, static_argnames=("coefs", "audio_block", "aligned")
)
def match_votes(
    db: jax.Array,
    db_mask: jax.Array | None,
    q: jax.Array,
    active: jax.Array,
    use2: jax.Array,
    tolerance: jax.Array | float,
    coefs: int = 1,
    audio_block: int = AUDIO_BLOCK,
    aligned: bool = False,
) -> jax.Array:
    """Vote counts ``[B, A]`` (int32).

    Args:
      db: ``[A, T, C]`` stored fingerprints (PAD_VALUE in padding).
      db_mask: ``[A, T]`` bool validity, or None when padding frames
        hold PAD_VALUE (the store layout) and the tolerance is below
        ``match_pallas.PALLAS_TOL_MAX``, which no band can then reach.
      q, active, use2: from :func:`prepare_query`.
      tolerance: scalar; inclusive band.
      coefs: number of matched coefficients (static; reference max is 2).
      aligned: documented extension — offset-consistent voting. The
        reference counts a vote when ANY stored frame is within tolerance
        (bag-of-frames, no time structure), which stops discriminating on
        similar-sounding corpora. With ``aligned=True`` a query frame's hit
        at stored frame t contributes to offset bucket ``t − f`` and the
        score is the best single offset's hit count — Shazam-style
        time-consistent matching, exact via one gather that
        re-indexes the hit tensor from (frame, time) to (frame, offset)
        space followed by a sum-over-frames and max-over-offsets.
    """
    a, t, c = db.shape
    if coefs < 1 or coefs > c:
        raise ValueError(f"coefs must be in [1, {c}]")
    tol = jnp.asarray(tolerance, dtype=jnp.float32)

    n_blocks = -(-a // audio_block)
    pad = n_blocks * audio_block - a
    if db_mask is None:
        db_mask = jnp.ones((a, t), bool)  # fused into the compare below
    db_p = jnp.pad(db, ((0, pad), (0, 0), (0, 0)))
    mask_p = jnp.pad(db_mask, ((0, pad), (0, 0)))
    db_blocks = db_p.reshape(n_blocks, audio_block, t, c)
    mask_blocks = mask_p.reshape(n_blocks, audio_block, t)

    q0 = q[..., 0]  # [B, F]

    def block_votes(blk):
        db_blk, m_blk = blk  # [Ab, T, C], [Ab, T]
        d0 = db_blk[..., 0]  # [Ab, T]
        ok = jnp.abs(q0[:, :, None, None] - d0[None, None]) <= tol  # [B,F,Ab,T]
        for ci in range(1, coefs):
            dc = db_blk[..., ci]
            okc = jnp.abs(q[..., ci][:, :, None, None] - dc[None, None]) <= tol
            if ci == 1:
                # out-of-band max2 drops only the max2 condition
                # (PARITY.md §3.3); coefs > 2 is a documented extension with
                # plain AND semantics
                okc |= ~use2[:, :, None, None]
            ok &= okc
        ok &= m_blk[None, None]
        ok &= active[:, :, None, None]
        if not aligned:
            hit = ok.any(axis=-1)  # [B, F, Ab]
            return hit.sum(axis=1, dtype=jnp.int32)  # [B, Ab]
        # offset voting: re-index t → offset = t − f (clamped gather; offset
        # range [−F+1, T−1]), then the best aligned diagonal is a
        # sum-over-f and max-over-offset. Offsets are processed in blocks so
        # peak memory stays at B·F·Ab·OFFSET_BLOCK regardless of T (one big
        # gather would materialise B·F·Ab·(T+F) — OOM for long tiers).
        f_n = ok.shape[1]
        t_n = ok.shape[3]
        n_off = t_n + f_n - 1
        n_off_pad = -(-n_off // OFFSET_BLOCK) * OFFSET_BLOCK
        offs = jnp.arange(n_off_pad) - (f_n - 1)  # padded tail is invalid
        f_idx = jnp.arange(f_n)

        def offset_block(off_blk):  # [Ob] -> [B, Ab]
            t_idx = f_idx[:, None] + off_blk[None, :]  # [F, Ob]
            valid = (t_idx >= 0) & (t_idx < t_n)
            t_idx = jnp.clip(t_idx, 0, t_n - 1)
            idx_full = jnp.broadcast_to(
                t_idx[None, :, None, :],
                (ok.shape[0], f_n, ok.shape[2], off_blk.shape[0]),
            )
            shifted = jnp.take_along_axis(ok, idx_full, axis=3)
            shifted &= valid[None, :, None, :]
            return shifted.sum(axis=1, dtype=jnp.int32).max(axis=-1)

        per_block = jax.lax.map(
            offset_block, offs.reshape(-1, OFFSET_BLOCK)
        )  # [n_blocks, B, Ab]
        return per_block.max(axis=0)  # [B, Ab]

    votes = jax.lax.map(block_votes, (db_blocks, mask_blocks))  # [nb, B, Ab]
    votes = jnp.moveaxis(votes, 1, 0).reshape(q.shape[0], n_blocks * audio_block)
    return votes[:, :a]


def top1(votes: jax.Array, audio_filter: jax.Array | None = None):
    """(best_index [B], match_count [B]) with lowest-index tiebreak.

    ``audio_filter`` is an optional bool ``[A]`` (e.g. context membership —
    the documented extension over the reference's global scan, PARITY.md D7).
    best_index is -1 when no audio got a vote.
    """
    b = votes.shape[0]
    if votes.shape[1] == 0:
        # empty DB: argmax over a zero-length axis raises — the contract
        # is best=-1, count=0 (nothing can match nothing)
        return (
            jnp.full((b,), -1, jnp.int32),
            jnp.zeros((b,), votes.dtype),
        )
    if audio_filter is not None:
        votes = jnp.where(audio_filter[None, :], votes, 0)
    best = jnp.argmax(votes, axis=1).astype(jnp.int32)
    count = jnp.take_along_axis(votes, best[:, None], axis=1)[:, 0]
    best = jnp.where(count > 0, best, -1)
    return best, count


def search_batch(
    db: jax.Array,
    db_mask: jax.Array,
    query: np.ndarray | jax.Array,
    n_frames: np.ndarray | jax.Array | None = None,
    coefs: int = 1,
    tolerance: float = DEF_SEARCH_TOLERANCE,
    freq_ignore_low: int = -1,
    freq_ignore_high: int = -1,
    audio_filter: jax.Array | None = None,
    trunc_coef1: bool = True,
    aligned: bool = False,
    with_top1: bool = True,
):
    """Full reference-semantics search over a batch of queries.

    Returns (best_index [B] int32 (-1 = not found), match_count [B] int32,
    votes [B, A] int32). ``aligned=True`` switches to offset-consistent
    voting (see :func:`match_votes`). ``with_top1=False`` returns
    ``(None, None, votes)`` — callers that rank on host (the engine's D5
    insertion-rank tiebreak) would otherwise pay a discarded device
    argmax+gather dispatch over the full [B, A] votes per search.
    """
    if tolerance < 0:
        tolerance = DEF_SEARCH_TOLERANCE  # fp_handler.c:252-256
    q, active, use2 = prepare_query(
        query, n_frames, freq_ignore_low, freq_ignore_high, trunc_coef1
    )
    votes = match_votes(
        db, db_mask, q, active, use2, tolerance, coefs=coefs, aligned=aligned
    )
    if not with_top1:
        return None, None, votes
    best, count = top1(votes, audio_filter)
    return best, count, votes
