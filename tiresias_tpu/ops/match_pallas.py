"""Fused tolerance-vote matchers: Pallas kernels through Triton for the GPU.

Two matchers behind ONE entry point, :func:`fused_votes`, that picks the
implementation by the platform the program is lowered for
(``lax.platform_dependent``):

* bag-of-frames votes (``aligned=False``), the reference's own semantics
  (PARITY.md §3): one vote per query frame per audio when ANY stored frame
  is inside the tolerance band;
* offset-consistent votes (``aligned=True``, PARITY.md D9): the best
  single time offset's hit count.

On a ``cuda`` lowering the Triton kernel runs; everywhere else the XLA form
(:func:`tiresias_tpu.ops.match_jax.match_votes`) does. ``interpret=True``
(tests only) runs the kernel in the Pallas interpreter on any platform. A
shape the kernel cannot serve (:func:`bag_kernel_serves`,
:func:`aligned_kernel_serves`) runs the XLA form on every platform, and a
warning names the rule that refused it.

Kernel design (Hopper: blocks run in parallel and in no order, so nothing
carries between programs):

* bag — grid ``(audio tiles, queries)``. A program loads its
  ``[A_t, T]`` DB tile per coefficient once (``A_t·T_pad ≤ 4096`` values,
  registers), then loops over the query frames inside the block:
  ``votes += any_T(|d0 − q0[f]| ≤ tol ∧ …)``.
* aligned — grid ``(audio tiles, offset tiles, queries)``. A program owns
  an ``[A_t, O_t]`` int32 tile of offset buckets (``o = t − f + F − 1``);
  for each query frame it loads the DB window ``t = o − F + 1 + f`` — per
  row one contiguous run of ``O_t·C`` values, so the loads coalesce —
  under a mask, ANDs the coefficients' band tests in registers and adds
  the hits. A second pass in XLA takes the max over offset tiles.

Both kernels can read their rows through an index array (``rows``,
``[B, K]``): the certified prefilter rescores each query's own top-K
candidates without gathering a ``[B, K, T, C]`` copy of the DB.

Masking is value-encoded, mirroring the store's layout: padding and
tombstoned DB frames hold ``PAD_VALUE`` (−1e6) so no tolerance band can
reach them, and inactive query frames are set to ``INACTIVE_Q`` (+1e6) —
valid while ``tolerance < PALLAS_TOL_MAX``, which callers check.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from tiresias_tpu.config import DEF_SEARCH_TOLERANCE
from tiresias_tpu.ops import match_jax
from tiresias_tpu.ops.mfcc_jax import PAD_VALUE
from tiresias_tpu.utils.logging import get_logger

log = get_logger(__name__)

INACTIVE_Q = 1.0e6  # pushed out of every tolerance band (PAD_VALUE is -1e6)

# Value-encoded masking breaks down for absurd tolerances: INACTIVE_Q
# (1e6) and PAD_VALUE (-1e6) sit ~1e6 away from every reachable
# fingerprint value ([-417, 127]), so any tolerance approaching that gap
# would let inactive query frames and padding DB frames "match". The
# masked XLA matcher serves such requests exactly.
PALLAS_TOL_MAX = 1e5

# Bag kernel: DB values one program holds per coefficient (registers of
# 4 warps), and the longest tier that fits one row of such a tile.
BAG_TILE_ELEMS = 4096
# Aligned kernel tile: audios x offset buckets per program (each offset
# bucket carries all C coefficients: A_t·O_t·C values per loaded tile).
ALIGNED_A_TILE = 32
ALIGNED_O_TILE = 32
NUM_WARPS = 4
# Flat int32 addressing: a DB (or DB shard) must hold fewer values.
MAX_DB_ELEMS = 2**31 - 1


def _pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def bag_kernel_serves(t: int, n_elems: int) -> bool:
    """The bag kernel's stated rule: one padded tier row (next power of
    two of ``t`` frames) fits a program's ``BAG_TILE_ELEMS`` tile, and the
    DB is addressable with int32 offsets."""
    return _pow2(t) <= BAG_TILE_ELEMS and n_elems <= MAX_DB_ELEMS


def aligned_kernel_serves(c: int, n_elems: int) -> bool:
    """The aligned kernel's stated rule: the stored coefficient count
    ``c`` is a power of two (a tile is reshaped to ``[A_t, O_t, c]``) and
    the DB is addressable with int32 offsets. Tier length and query length
    are unbounded — offsets are tiled over the grid and query frames are
    looped."""
    return c == _pow2(c) and n_elems <= MAX_DB_ELEMS


def _query_rows(q, active, use2, coefs: int):
    """Kernel query operand ``[B, R, F_pad]`` (powers of two): rows
    ``0..coefs-1`` hold the coefficient values with the active mask
    value-encoded into row 0, row ``coefs`` holds the use2 flag. Padded
    frames are never read (the kernels loop over the true F)."""
    rows = [jnp.where(active, q[..., 0], INACTIVE_Q)]
    rows += [q[..., ci] for ci in range(1, coefs)]
    rows.append(use2.astype(jnp.float32))
    out = jnp.stack(rows, axis=1)  # [B, coefs+1, F]
    b, r, f = out.shape
    return jnp.pad(out, ((0, 0), (0, _pow2(r) - r), (0, _pow2(f) - f)),
                   constant_values=INACTIVE_Q)


def _frame_ok(load, q_ref, b, f, coefs: int, tol):
    """Per-frame band test shared by both kernels: ``load(c)`` yields the
    DB tile of coefficient ``c``; out-of-band max2 (use2 ≤ 0) drops only
    the coef-2 condition (PARITY.md §3.3), coefs > 2 use plain AND."""
    ok = jnp.abs(load(0) - q_ref[b, 0, f]) <= tol
    for c in range(1, coefs):
        okc = jnp.abs(load(c) - q_ref[b, c, f]) <= tol
        if c == 1:
            okc = okc | (q_ref[b, coefs, f] <= 0.0)
        ok = ok & okc
    return ok


def _row_offsets(rows_ref, b, i, a_t: int, n_rows: int, row_stride: int):
    """Flat offsets ``[a_t]`` of this program's DB rows and their
    validity: the tile's own rows, or the rows its index array names."""
    a_idx = i * a_t + jnp.arange(a_t)
    valid = a_idx < n_rows
    a_idx = jnp.minimum(a_idx, n_rows - 1)
    if rows_ref is not None:
        a_idx = pl_triton.load(rows_ref.at[b, a_idx])
    return a_idx * row_stride, valid


def _bag_kernel(q_ref, d_ref, tol_ref, *rest, coefs, f_total, a_t, t, c_all,
                n_rows, has_rows):
    rows_ref = rest[0] if has_rows else None
    out_ref = rest[-1]
    i = pl.program_id(0)
    b = pl.program_id(1)
    tol = tol_ref[0]
    t_pad = _pow2(t)
    base, a_valid = _row_offsets(rows_ref, b, i, a_t, n_rows, t * c_all)
    t_idx = jnp.arange(t_pad)
    t_valid = t_idx < t
    offs = base[:, None] + (jnp.minimum(t_idx, t - 1) * c_all)[None, :]
    mask = a_valid[:, None] & t_valid[None, :]
    d = [
        pl_triton.load(d_ref.at[offs + c], mask=mask, other=PAD_VALUE)
        for c in range(coefs)
    ]

    def body(f, votes):
        ok = _frame_ok(lambda c: d[c], q_ref, b, f, coefs, tol)
        return votes + jnp.max(ok.astype(jnp.int32), axis=1)

    votes = jax.lax.fori_loop(0, f_total, body, jnp.zeros((a_t,), jnp.int32))
    out_ref[b, pl.ds(i * a_t, a_t)] = votes


def _aligned_kernel(q_ref, d_ref, tol_ref, *rest, coefs, f_total, a_t, o_t,
                    t, c_all, n_rows, has_rows):
    rows_ref = rest[0] if has_rows else None
    out_ref = rest[-1]
    i = pl.program_id(0)
    j = pl.program_id(1)
    b = pl.program_id(2)
    tol = tol_ref[0]
    base, a_valid = _row_offsets(rows_ref, b, i, a_t, n_rows, t * c_all)
    # one element per (offset, coefficient) of the tile: a row's window of
    # o_t frames is ONE contiguous run of o_t·C values in the [A, T, C]
    # layout, so the loads coalesce; the per-frame AND over coefficients
    # is a min over the trailing axis after a reshape to [a_t, o_t, C]
    e = jnp.arange(o_t * c_all)
    c_e = e % c_all
    t_rel = e // c_all
    o_first = j * o_t - (f_total - 1)

    def body(f, acc):
        tt = o_first + f + t_rel
        mask = a_valid[:, None] & ((tt >= 0) & (tt < t))[None, :]
        offs = base[:, None] + (jnp.clip(tt, 0, t - 1) * c_all + c_e)[None, :]
        d = pl_triton.load(d_ref.at[offs], mask=mask, other=PAD_VALUE)
        qv = pl_triton.load(q_ref.at[b, jnp.minimum(c_e, coefs - 1), f])
        # coefficients past `coefs` never vote against; out-of-band max2
        # (use2 ≤ 0) drops only the coef-2 condition (PARITY.md §3.3)
        skip = (c_e >= coefs) | ((c_e == 1) & (q_ref[b, coefs, f] <= 0.0))
        hit = (jnp.abs(d - qv[None, :]) <= tol) | skip[None, :]
        hit = jnp.min(hit.astype(jnp.int32).reshape(a_t, o_t, c_all), axis=2)
        return acc + hit

    acc = jax.lax.fori_loop(
        0, f_total, body, jnp.zeros((a_t, o_t), jnp.int32)
    )
    out_ref[b, j, pl.ds(i * a_t, a_t)] = jnp.max(acc, axis=1)


def _kernel_votes(db, q, active, use2, tol, rows, *, coefs, aligned,
                  interpret):
    """[B, A] (or [B, K] with ``rows``) votes from the Triton kernel."""
    a, t, c = db.shape
    b, f, _ = q.shape
    n = a if rows is None else rows.shape[1]
    q_rows = _query_rows(q, active, use2, coefs)
    args = [q_rows, db.reshape(-1), jnp.reshape(tol, (1,)).astype(jnp.float32)]
    if rows is not None:
        args.append(rows.astype(jnp.int32))
    common = dict(coefs=coefs, f_total=f, t=t, c_all=c, n_rows=n,
                  has_rows=rows is not None)
    if aligned:
        a_t, o_t = ALIGNED_A_TILE, ALIGNED_O_TILE
        n_o = -(-(t + f - 1) // o_t)
        kernel = functools.partial(_aligned_kernel, a_t=a_t, o_t=o_t, **common)
        grid = (-(-n // a_t), n_o, b)
        out_shape = (b, n_o, grid[0] * a_t)
        name = "tiresias_aligned_votes"
    else:
        a_t = max(1, BAG_TILE_ELEMS // _pow2(t))
        kernel = functools.partial(_bag_kernel, a_t=a_t, **common)
        grid = (-(-n // a_t), b)
        out_shape = (b, grid[0] * a_t)
        name = "tiresias_bag_votes"
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.int32),
        grid=grid,
        in_specs=[pl.no_block_spec] * len(args),
        out_specs=pl.no_block_spec,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name=name,
    )(*args)
    if aligned:
        out = out.max(axis=1)
    return out[:, :n]


def _xla_votes(db, q, active, use2, tol, rows, *, coefs, aligned):
    """The XLA form of the same votes (padding rows/frames hold
    PAD_VALUE, so no mask operand is needed)."""
    if rows is None:
        return match_jax.match_votes(
            db, None, q, active, use2, tol, coefs=coefs, aligned=aligned
        )

    def one(args):
        qb, ab, ub, rb = args
        return match_jax.match_votes(
            db[rb], None, qb[None], ab[None], ub[None], tol, coefs=coefs,
            aligned=aligned,
        )[0]

    return jax.lax.map(one, (q, active, use2, rows))


def _serves(db, aligned: bool) -> bool:
    a, t, c = db.shape
    n_elems = a * t * c
    if aligned:
        return aligned_kernel_serves(c, n_elems)
    return bag_kernel_serves(t, n_elems)


@functools.partial(
    jax.jit, static_argnames=("coefs", "aligned", "interpret")
)
def fused_votes(
    db: jax.Array,
    q: jax.Array,
    active: jax.Array,
    use2: jax.Array,
    tolerance: jax.Array | float,
    coefs: int = 1,
    aligned: bool = False,
    rows: jax.Array | None = None,
    interpret: bool = False,
) -> jax.Array:
    """Votes ``[B, A]`` int32 — or ``[B, K]`` for the per-query DB rows
    ``rows [B, K]`` — bag (``aligned=False``) or aligned.

    Args:
      db: ``[A, T, C]`` with PAD_VALUE in padding (store layout).
      q / active / use2: from :func:`match_jax.prepare_query`.
      interpret: run the kernel in the Pallas interpreter (tests).
    """
    a, t, c = db.shape
    if coefs < 1 or coefs > c:
        raise ValueError(f"coefs must be in [1, {c}]")
    tol = jnp.asarray(tolerance, jnp.float32)
    # a PAD_VALUE query frame (a padded fingerprint searched with no
    # frame count) would match DB padding once no mask operand exists;
    # under a mask it matches nothing — make it inactive instead
    active = active & (q[..., 0] > PAD_VALUE / 2)
    kw = dict(coefs=coefs, aligned=aligned)
    xla = functools.partial(_xla_votes, **kw)
    if not _serves(db, aligned):
        log.warning(
            "%s kernel cannot serve db %s (%s); running the XLA form",
            "aligned" if aligned else "bag", db.shape,
            "coefficient count not a power of two, or int32 addressing"
            if aligned else
            f"tier > {BAG_TILE_ELEMS} frames or int32 addressing",
        )
        return xla(db, q, active, use2, tol, rows)
    kernel = functools.partial(_kernel_votes, interpret=interpret, **kw)
    if interpret:
        return kernel(db, q, active, use2, tol, rows)
    return jax.lax.platform_dependent(
        db, q, active, use2, tol, rows, cuda=kernel, default=xla
    )


PREFILTER_K = 1024  # candidates rescored exactly by the fused matcher


@functools.partial(
    jax.jit,
    static_argnames=("specs", "coefs", "k", "interpret", "top", "aligned"),
)
def aligned_prefiltered_votes(
    db: jax.Array,
    maps: tuple,
    q: jax.Array,
    active: jax.Array,
    use2: jax.Array,
    tolerance: jax.Array | float,
    specs: tuple = (),
    coefs: int = 2,
    k: int = PREFILTER_K,
    interpret: bool = False,
    ctx_ids: jax.Array | None = None,
    ctx_id: jax.Array | int | None = None,
    top: int = 1,
    aligned: bool = True,
):
    """Aligned (or strict BAG) votes via a CERTIFIED two-stage search:
    lattice bounds → top-k candidate selection → exact rescoring of the
    candidates with the requested matcher.

    The key inequalities (hold per audio, for any inputs):

      aligned_score(a) ≤ bag_score(a)            — the best single offset's
        hit count can't exceed the any-offset hit count; and
      bag_score(a) ≤ min_c scaled_lattice_votes_c(a)  — an aligned hit
        passes EVERY coef's tolerance test, and each coef's clipped-scaled
        distance map at s·tol+1 upper-bounds that coef's test
        (match_lattice.bound_votes) — a couple of matmuls.

    ``aligned=False`` rescores candidates with the BAG matcher instead
    (the reference's own strict multi-coef configuration — coefs=2, no
    truncation, fp_handler.c:247-250,321): the chain's middle term IS
    the bag score, so the same bound certifies it a fortiori. This turns
    the strict config's O(B·F·A·T·C) full scan into the same ~A/k
    two-stage cost the accuracy mode gets.

    So rescoring only the top-k audios BY BOUND is provably exact whenever
    ``best_rescored > max unselected bound`` (every unselected audio's
    true score ≤ its bound ≤ that max < best) — the returned
    ``certificate``. The caller falls back to the full scan when it is
    False (pathological corpora: ≥k near-duplicates of the query). Cost:
    O(B·K·A) matmuls + O(B·F·k·T·C) rescore instead of O(B·F·A·T·C).

    Candidate selection uses ``approx_max_k``, which lowers to an exact
    top-k on the GPU and CPU. Approximation could not break exactness
    either way: the certificate is checked against the EXACT maximum over
    the unselected set (selected entries scattered out first), so a
    missed high-bound audio simply fails the certificate and triggers the
    full-scan fallback.

    Context filtering: ``ctx_ids`` ([A] int32 per-row context ids,
    store.ctx_ids_for) + ``ctx_id`` (traced scalar) restrict the search to
    one context's rows (the reference's per-context scan,
    /root/reference/src/fp_handler.c:308-359; here the opt-in
    ``filter_context`` extension — PARITY.md D7). Out-of-context rows get
    bound −1 (never selected above a live in-context row) and any that ARE
    selected — fewer than k in-context rows exist — rescore to 0, so the
    certificate certifies the IN-context winner against unselected
    in-context bounds only.

    ``top`` > 1 certifies a TOP-K result instead of top-1: when the
    certificate holds, every audio whose true score reaches the k-th best
    rescored score is inside the candidate set with its exact score, so
    the scattered votes yield the exact lexicographic top-``top`` listing
    (zero-vote rows never appear in a listing).

    Returns (votes [B, A] int32 — candidate scores scattered, zeros
    elsewhere; certificate [B] bool).
    """
    if not specs or len(specs) != len(maps):
        # an empty default would crash opaquely deep in tracing
        # (bound_votes' loop never runs → None flows into approx_max_k)
        raise ValueError(
            "aligned_prefiltered_votes requires matching non-empty "
            "specs/maps (store.bound_maps_for provides both)"
        )
    from tiresias_tpu.ops.match_lattice import (
        bound_votes,
        certificate,
        scatter_candidates,
    )

    a = db.shape[0]
    b = q.shape[0]
    k = min(k, a)
    if top > k:
        # a top-k listing larger than the candidate budget cannot be
        # served exactly — the caller must full-scan instead
        raise ValueError(f"top={top} exceeds the candidate budget k={k}")
    tol = jnp.asarray(tolerance, jnp.float32)
    # band filtering is already inside `active` (computed on the raw q0 by
    # prepare_query); the bound's lattice band stays OPEN or a frame at a
    # band edge could be dropped from the bound but not from the aligned
    # score, breaking the inequality. use2 rides along so coef-1's
    # band-bypass frames count as automatic hits in the bound too.
    bound = bound_votes(specs, maps, q, active, use2, tol)  # [B, A] int32
    keep = None
    if ctx_ids is not None:
        keep = ctx_ids == jnp.asarray(ctx_id, ctx_ids.dtype)  # [A]
        bound = jnp.where(keep[None, :], bound, -1)
    _, idx = jax.lax.approx_max_k(
        bound.astype(jnp.float32), k, recall_target=0.99
    )  # [B, K]
    rows = jnp.arange(b)[:, None]
    unselected_max = bound.at[rows, idx].set(-1).max(axis=1)

    votes_k = fused_votes(
        db, q, active, use2, tol, coefs=coefs, aligned=aligned, rows=idx,
        interpret=interpret,
    )  # [B, K]
    if keep is not None:
        # an out-of-context candidate can still be selected when fewer
        # than k in-context rows exist; its true votes must not win,
        # certify, or scatter into the filtered result
        votes_k = jnp.where(keep[idx], votes_k, 0)
    # shared certification rule + candidate scatter (match_lattice):
    # every prefiltered variant — dialplan lattice, aligned, shard-mapped,
    # fused — certifies and lays out votes identically by construction
    votes = scatter_candidates(votes_k, idx, a)
    return votes, certificate(votes_k, unselected_max, top)


def search_batch_pallas(
    db: jax.Array,
    query: np.ndarray | jax.Array,
    n_frames: np.ndarray | jax.Array | None = None,
    coefs: int = 1,
    tolerance: float = DEF_SEARCH_TOLERANCE,
    freq_ignore_low: int = -1,
    freq_ignore_high: int = -1,
    audio_filter: jax.Array | None = None,
    trunc_coef1: bool = True,
    aligned: bool = False,
    interpret: bool = False,
    with_top1: bool = True,
):
    """Fused-matcher equivalent of ``match_jax.search_batch``.

    Takes the store-layout ``db`` (PAD_VALUE padding) directly — no mask
    operand. Returns (best [B], match_count [B], votes [B, A]).
    ``aligned=True`` dispatches the offset-consistent matcher (the D9
    accuracy mode)."""
    if tolerance < 0:
        tolerance = DEF_SEARCH_TOLERANCE  # fp_handler.c:252-256
    if tolerance >= PALLAS_TOL_MAX:
        raise ValueError(
            f"tolerance {tolerance} breaks the fused matchers' "
            f"value-encoded masking (INACTIVE_Q/PAD_VALUE sentinels at "
            f"±1e6) — use the XLA matcher for tolerances >= {PALLAS_TOL_MAX}"
        )
    q, active, use2 = match_jax.prepare_query(
        query, n_frames, freq_ignore_low, freq_ignore_high, trunc_coef1
    )
    votes = fused_votes(
        db, q, active, use2, jnp.float32(tolerance), coefs=coefs,
        aligned=aligned, interpret=interpret,
    )
    if not with_top1:
        return None, None, votes
    best, count = match_jax.top1(votes, audio_filter)
    return best, count, votes
