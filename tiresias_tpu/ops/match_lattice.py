"""Lattice matcher: matmul-native exact search for the dialplan path.

The reference's dialplan always searches with ``coefs=1`` and truncates the
query's max1 to an integer (/root/reference/src/application_handler.c:180,
/root/reference/src/fp_handler.c:290). That truncation means every query
frame's value lives on an integer lattice — so the whole vote computation
factorizes exactly:

    M[a, k]   = min_t |db[a, t, 0] − k|          (per-audio distance map,
                                                  precomputed once per DB)
    H[k, a]   = M[a, k] <= tol                   (hit map, per query tol)
    C[b, k]   = #{active frames f : trunc(q[b,f,0]) == k}   (histogram)
    votes[b,a] = sum_k C[b,k] * H[k,a]           (ONE [B,K]x[K,A] matmul)

This is bit-exact w.r.t. the reference semantics (PARITY.md §3) because all
query frames sharing an integer value have identical hit outcomes per audio,
and the per-frame "one vote per audio" rule (GROUP BY) is exactly the
∃t — i.e. min_t — test. The O(B·F·A·T) broadcast-compare of the general
matcher becomes an O(A·T·K) one-off build plus an O(B·K·A) matmul per
query — at 10k tracks ~1.3 G elementwise compares collapse into a ~5 MFLOP
matmul. Counts and 0/1 hits are small integers, exact in float32.

Band-ignore (/root/reference/src/fp_handler.c:293-306) is a k-range mask on
the histogram — also exact, since the filter tests the truncated value.

Limits: coefs=2 needs the joint per-frame condition (min over t does not
factorize across coefficients) and the D8 no-truncation mode has real-valued
queries — both take the fused matchers (:mod:`tiresias_tpu.ops.match_pallas`)
or :mod:`tiresias_tpu.ops.match_jax`. The engine dispatches automatically.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tiresias_tpu.config import DEF_SEARCH_TOLERANCE
from tiresias_tpu.ops import match_jax

# Integer lattice covering every reachable truncated fingerprint value:
# stored values are 10*log10|coef| floored at 10*log10(2e-42) ≈ -417
# (PARITY.md D1); the upper edge of +127 corresponds to |coef| ≥ 1e12.7,
# far beyond anything the DSP chain can emit from finite PCM. Query frames
# whose truncated value still falls outside the lattice (NaN, ±inf, or a
# pathological magnitude) contribute ZERO votes — not an edge-bucket vote —
# matching match_jax, whose in-range DB values cannot sit within any sane
# tolerance of such a value. K is a multiple of 128 for clean matmul tiling.
K_MIN = -512
K_SIZE = 640  # covers [-512, 127]


def build_value_map(
    db0: jax.Array, db_mask: jax.Array, k_min: int = K_MIN, k_size: int = K_SIZE
) -> jax.Array:
    """``M [A, K]``: distance from each lattice integer to the nearest stored
    max1 frame of each audio. Masked/padding frames are excluded.

    Built once per DB mutation (see :func:`_build_value_map_block` for the
    exact distance-transform math). Rows are independent, so large HOST
    (numpy) inputs are processed in FIXED-shape chunks of ``_BUILD_CHUNK``
    rows: ONE compiled executable serves every DB size (per frame-tier),
    instead of a fresh XLA compile each time the padded audio count
    grows, and each
    chunk's H2D upload overlaps the previous chunk's compute. Large
    DEVICE-array inputs (e.g. a stale-view rebuild from ``view.db``) are
    chunked too, via ``lax.map`` inside one jit: a single-call distance
    transform materialises ~6 f32 ``[A, K]`` temps at once (tens of GB at
    1M rows) — the same bound _build_bound_map already enforces.
    """
    a = db0.shape[0]
    if a <= _BUILD_CHUNK:
        return _build_value_map_block(db0, db_mask, k_min=k_min, k_size=k_size)
    if not isinstance(db0, np.ndarray):
        try:  # mesh-sharded arrays stay single-call: GSPMD row-partitions
            multi = len(db0.sharding.device_set) > 1
        except Exception:  # noqa: BLE001 - tracers/odd arrays
            multi = False
        if multi:
            return _build_value_map_block(
                db0, db_mask, k_min=k_min, k_size=k_size
            )
        return _build_value_map_chunked(
            db0, db_mask, k_min=k_min, k_size=k_size
        )
    mask_np = np.asarray(db_mask)  # hoisted: one conversion, not per chunk
    parts = []
    for lo in range(0, a, _BUILD_CHUNK):
        hi = min(lo + _BUILD_CHUNK, a)
        blk, msk = db0[lo:hi], mask_np[lo:hi]
        if hi - lo < _BUILD_CHUNK:
            pad = _BUILD_CHUNK - (hi - lo)
            blk = np.pad(blk, ((0, pad), (0, 0)))
            msk = np.pad(msk, ((0, pad), (0, 0)))  # pad rows: all-masked
        parts.append(
            _build_value_map_block(
                jnp.asarray(blk), jnp.asarray(msk), k_min=k_min, k_size=k_size
            )
        )
    return jnp.concatenate(parts, axis=0)[:a]


@functools.partial(jax.jit, static_argnames=("k_min", "k_size"))
def _build_value_map_chunked(db0, db_mask, k_min: int, k_size: int):
    a, t = db0.shape
    pad = -(-a // _BUILD_CHUNK) * _BUILD_CHUNK - a
    db_p = jnp.pad(db0, ((0, pad), (0, 0)))
    mask_p = jnp.pad(db_mask, ((0, pad), (0, 0)))  # pad rows all-masked

    def block(args):
        blk, msk = args
        return _build_value_map_block(blk, msk, k_min=k_min, k_size=k_size)

    blocks = jax.lax.map(
        block,
        (
            db_p.reshape(-1, _BUILD_CHUNK, t),
            mask_p.reshape(-1, _BUILD_CHUNK, t),
        ),
    )
    return blocks.reshape(-1, k_size)[:a]


# Fixed row-chunk size for the chunked build: large enough that the O(A·K)
# scatter/cummin work dominates dispatch overhead, small enough to compile
# in seconds. 8192 rows x 1024 frames is a 32 MB input block.
_BUILD_CHUNK = 8192


@functools.partial(jax.jit, static_argnames=("k_min", "k_size"))
def _build_value_map_block(
    db0: jax.Array, db_mask: jax.Array, k_min: int = K_MIN, k_size: int = K_SIZE
) -> jax.Array:
    """One fixed-shape block of :func:`build_value_map`.

    Exact 1-D distance transform in O(A·(T + K)) instead of the brute-force
    O(A·T·K): bucket each value by ``floor(v)``, keep the per-bucket min and
    max VALUE (not fraction), then

        M[a, k] = min( fl(suffix_min_{j>=k}(vmin[a,j]) − k),
                       fl(k − prefix_max_{j<k}(vmax[a,j])) )

    This is bitwise identical to ``min_t |fl(v − k)|``: every value v in a
    bucket ≥ k satisfies v ≥ k (so |v−k| = v−k, one f32 subtraction — the
    same single rounding the brute force performs), f32 subtraction is
    monotone in v, so the min over v commutes with the subtraction; values
    in buckets < k satisfy v < k symmetrically. Out-of-lattice values clip
    to the edge BUCKET but keep their true value, so their distances stay
    exact. 40-100x faster at 10k-100k tracks (the post-ingest first-search
    stall this build used to cause). All-masked rows (chunk padding) yield
    +inf distances everywhere — they can never be within tolerance.
    """
    a, t = db0.shape
    pos_inf = jnp.float32(jnp.inf)
    neg_inf = jnp.float32(-jnp.inf)
    v_lo = jnp.where(db_mask, db0, pos_inf)  # for suffix-min (above side)
    v_hi = jnp.where(db_mask, db0, neg_inf)  # for prefix-max (below side)
    bins = jnp.clip(
        jnp.floor(db0).astype(jnp.int32) - k_min, 0, k_size - 1
    )  # masked entries scatter ±inf, which are identities for min/max
    rows = jnp.arange(a)[:, None]
    vmin = jnp.full((a, k_size), pos_inf, jnp.float32).at[rows, bins].min(v_lo)
    vmax = jnp.full((a, k_size), neg_inf, jnp.float32).at[rows, bins].max(v_hi)
    suffix_min = jax.lax.cummin(vmin, axis=1, reverse=True)  # min_{j>=k}
    prefix_max = jnp.pad(
        jax.lax.cummax(vmax, axis=1)[:, :-1], ((0, 0), (1, 0)),
        constant_values=-np.inf,
    )  # max_{j<k}
    ks = jnp.arange(k_min, k_min + k_size, dtype=jnp.float32)
    above = suffix_min - ks[None, :]
    below = ks[None, :] - prefix_max
    return jnp.minimum(above, below)


# Bound-map specs for the certified aligned prefilter
# (match_pallas.aligned_prefiltered_votes): per-coefficient value maps on
# CLIPPED, SCALED values. Clipping is a 1-Lipschitz contraction
# (|clip(x)−clip(y)| ≤ |x−y|), so a true hit |q_c − d_c| ≤ tol implies a
# clipped-scaled lattice hit within s·tol + 1 — the map stays a valid
# upper bound while the ×s scaling shrinks the truncation loss to 1/s of
# a unit (the plain integer lattice's ±1 loss swamps accuracy-mode
# tolerances of 0.01-0.1). k_size has 128 spare buckets past hi·s so the
# clip-to-hi edge value still lands in range.
BOUND_SPEC_C0 = (4.0, -120.0, 40.0)  # coef 0 spans the energy floor
BOUND_SPEC_CN = (8.0, -40.0, 40.0)  # higher coefs concentrate near 0


def bound_coef_indices(n_coefs: int) -> tuple[int, ...]:
    """Which coefficients the prefilter bound tests. ``n_coefs`` is the
    number of coefs the SEARCH tests — a bound on a coef the aligned
    condition does not test would be unsound (an aligned hit need not
    pass it). Within that set: coef 0 tracks total energy and matches
    almost anything (the reference's own weakness); coefs 1-2
    discriminate, so prefer them. The 2-coef case (the reference's own
    strict library configuration, fp_handler.c:247-250) ANDs BOTH
    available coefs: min over more valid bounds is strictly tighter,
    and with only coef 1 available the bound could not separate
    wide-spectrum corpora (round-5 strict-bag fast path)."""
    if n_coefs >= 3:
        return (1, 2)
    if n_coefs == 2:
        return (0, 1)
    return (0,)


def bound_specs(n_coefs: int) -> tuple:
    """Static per-coef specs ``(coef, scale, lo, hi, k_min, k_size)`` for
    the bound maps (hashable — they ride jit as static arguments)."""
    out = []
    for c in bound_coef_indices(n_coefs):
        s, lo, hi = BOUND_SPEC_C0 if c == 0 else BOUND_SPEC_CN
        out.append((c, s, lo, hi, int(lo * s), int((hi - lo) * s) + 128))
    return tuple(out)


def build_bound_maps(
    db: jax.Array, db_mask: jax.Array, coefs: int | None = None
) -> tuple:
    """Per-coef scaled distance maps for the aligned prefilter.

    ``coefs``: the number of coefficients the SEARCH will test (defaults
    to everything stored) — bound maps are only valid for coefs the
    aligned condition actually tests.

    Returns ``(specs, maps)`` — static spec tuple plus one
    ``[A, k_size]`` :func:`build_value_map` per spec, built over
    ``clip(db[...,c], lo, hi) * scale``.
    """
    if coefs is None:
        coefs = db.shape[2]
    specs = bound_specs(min(coefs, db.shape[2]))
    maps = []
    for c, s, lo, hi, k_min, k_size in specs:
        maps.append(
            _build_bound_map(db[..., c], db_mask, s, lo, hi, k_min, k_size)
        )
    return specs, tuple(maps)


# Quantization of the bound maps: distances are stored as
# ``floor(d * BOUND_Q)`` in uint8, saturating at BOUND_FAR. The bound
# thresholds are tiny (``s*tol + 1`` ≈ 1-2 scaled units for accuracy-mode
# tolerances), so only the near field needs resolution: 1/64-unit steps
# keep the quantization slack at 1/64 of the lattice's own ±1 truncation
# allowance (0.002 dB at the s=8 specs — certification rates are
# untouched), while everything past 255/64 ≈ 3.98 units — double any
# practical threshold — saturates. Masked/tombstoned rows store
# BOUND_FAR (their +inf); if a pathological tolerance pushes the scaled
# threshold to 255, far rows merely pass — the bound inflates (the
# prefilter de-certifies and the engine full-scans) but stays VALID
# (a superset can only grow).
BOUND_Q = 64
BOUND_FAR = 255


@functools.partial(
    jax.jit, static_argnames=("s", "lo", "hi", "k_min", "k_size")
)
def _build_bound_map(db_c, mask, s, lo, hi, k_min: int, k_size: int):
    """One bound map, built in row chunks (a single-call distance
    transform at 1M rows materialises ~6 f32 [A, K] temps — tens of GB;
    ``lax.map`` over fixed chunks bounds the peak at one chunk's temps
    plus the quantized output, and the clip/scale fuses into each chunk
    so no full-size scaled temp exists either), quantized to uint8 as
    ``floor(d * BOUND_Q)`` saturating at :data:`BOUND_FAR`: distances
    are >= 0 and ``floor(d*Q) <= d*Q``, so the stored map only
    under-states distances — ``(map <= tol*Q)`` stays a SUPERSET of the
    true hit set (the bound stays valid, and :func:`bound_votes` scales
    its threshold to match) at a QUARTER of the f32 HBM footprint and
    matmul read traffic — at 1M tracks the per-query cost of the
    certified prefilter is dominated by streaming these maps. The
    quantization slack (< 1/Q scaled unit) is 64x tighter than the
    lattice's own ±1 truncation allowance, so certification rates are
    untouched. The integer-vs-float compare is exact: u8 promotes to
    f32 losslessly."""

    def block(args):
        db_cs, masks = args
        scaled = jnp.clip(db_cs, lo, hi) * s
        m = _build_value_map_block(scaled, masks, k_min=k_min, k_size=k_size)
        # inf (all-masked rows) * Q = inf -> saturates to BOUND_FAR
        return jnp.minimum(
            jnp.floor(m * float(BOUND_Q)), float(BOUND_FAR)
        ).astype(jnp.uint8)

    a, t = db_c.shape
    if a <= _BUILD_CHUNK:
        return block((db_c, mask))
    pad = -(-a // _BUILD_CHUNK) * _BUILD_CHUNK - a
    db_p = jnp.pad(db_c, ((0, pad), (0, 0)))
    mask_p = jnp.pad(mask, ((0, pad), (0, 0)))  # pad rows all-masked → +inf
    blocks = jax.lax.map(
        block,
        (
            db_p.reshape(-1, _BUILD_CHUNK, t),
            mask_p.reshape(-1, _BUILD_CHUNK, t),
        ),
    )
    return blocks.reshape(-1, k_size)[:a]


def bound_votes(specs: tuple, maps: tuple, q: jax.Array, active: jax.Array,
                use2: jax.Array, tolerance: jax.Array | float) -> jax.Array:
    """Upper bound on every audio's ALIGNED score: ``min`` over the bound
    coefs of that coef's clipped-scaled lattice votes (an aligned hit
    passes every coef's test, so its frame counts once in each).

    Coef index 1 (the reference's max2) is special: the matcher DROPS its
    condition for frames whose q1 is outside the freq-ignore band
    (``use2`` False — PARITY.md §3.3, match_jax.match_votes). A bypassed
    frame is an automatic coef-1 hit, so its lattice count must not be
    trusted: count only ``active & use2`` frames through the lattice and
    credit every bypassed active frame unconditionally — otherwise the
    "bound" could under-state the true aligned score and certify a wrong
    winner."""
    tol = jnp.asarray(tolerance, jnp.float32)
    neg_inf, pos_inf = jnp.float32(-jnp.inf), jnp.float32(jnp.inf)
    out = None
    for (c, s, lo, hi, k_min, k_size), m in zip(specs, maps):
        act_c = (active & use2) if c == 1 else active
        qc = jnp.clip(q[..., c], lo, hi) * s
        thr = s * tol + 1.0
        if m.dtype == jnp.uint8:  # quantized map: floor(d * BOUND_Q)
            thr = thr * float(BOUND_Q)
        v = lattice_votes(
            m, qc, act_c, thr, neg_inf, pos_inf,
            k_min=k_min, k_size=k_size,
        )
        if c == 1:
            bypassed = (active & ~use2).sum(axis=1, dtype=v.dtype)
            v = v + bypassed[:, None]
        out = v if out is None else jnp.minimum(out, v)
    return out


def _frame_buckets(q0, active, band_lo, band_hi, k_min: int, k_size: int):
    """Per-frame lattice bucket index + validity under the reference's
    truncation, lattice-range, and band rules. Shared by the histogram
    matmul (:func:`lattice_votes`) and the prefilter's exact per-frame
    rescore (:func:`lattice_prefiltered_votes`), so the two can never
    diverge on which frames count.

    The band filter tests the TRUNCATED value (fp_handler.c:293-306),
    which is constant per lattice bucket — filtering frames here is
    exactly equivalent to zeroing whole lattice rows. Out-of-lattice
    values (NaN/±inf/pathological magnitudes) must score zero votes, not
    be folded into the edge bucket; NaN compares false on both sides, so
    it is masked too."""
    kq = jnp.trunc(q0)  # the reference (int) cast
    in_range = (kq >= k_min) & (kq < k_min + k_size)
    in_band = (kq >= band_lo) & (kq <= band_hi)
    idx = jnp.clip(kq.astype(jnp.int32) - k_min, 0, k_size - 1)
    return idx, active & in_range & in_band


def _histogram(q0, active, band_lo, band_hi, k_min: int, k_size: int):
    """Query histogram ``C [B, K]`` — exact counts via scatter-add, not a
    broadcast one-hot compare + sum (whose lowering was far slower to
    compile)."""
    idx, valid = _frame_buckets(q0, active, band_lo, band_hi, k_min, k_size)
    b = q0.shape[0]
    c = jnp.zeros((b, k_size), jnp.float32)
    return c.at[jnp.arange(b)[:, None], idx].add(valid.astype(jnp.float32))


def _hit_matmul(c, value_map, tol):
    """``votes [B, A] = C @ (M <= tol).T`` — the single contraction.
    Contract on k of BOTH operands (no transpose): materialising H.T
    through device memory would cost far more than the matmul itself at
    1M tracks; without the transpose XLA can fuse the tolerance compare
    into the matmul's operand read (for the uint8-quantized maps that
    read is a QUARTER of the f32 bytes). HIGHEST precision: the 0/1 and
    count operands are exact in float32, not in TF32 or bf16."""
    h = (value_map <= tol).astype(jnp.float32)  # [A, K]
    votes = jax.lax.dot_general(
        c, h, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return votes.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k_min", "k_size"))
def lattice_votes(
    value_map: jax.Array,
    q0: jax.Array,
    active: jax.Array,
    tolerance: jax.Array | float,
    band_lo: jax.Array | float,
    band_hi: jax.Array | float,
    k_min: int = K_MIN,
    k_size: int = K_SIZE,
) -> jax.Array:
    """Votes ``[B, A]`` via histogram × hit-map matmul.

    Args:
      value_map: ``M [A, K]`` from :func:`build_value_map`.
      q0: ``[B, F]`` query max1 values (pre-truncation is applied here).
      active: ``[B, F]`` valid-frame mask (frame-count only; the band filter
        is applied internally on the lattice).
      tolerance: scalar, inclusive.
      band_lo / band_hi: thresholds in the log domain (±inf = disabled),
        from :func:`tiresias_tpu.ops.match_jax.band_thresholds`.
    """
    tol = jnp.asarray(tolerance, dtype=jnp.float32)
    c = _histogram(q0, active, band_lo, band_hi, k_min, k_size)
    return _hit_matmul(c, value_map, tol)


@jax.jit
def quantize_value_map(value_map: jax.Array) -> jax.Array:
    """uint8 companion of the dialplan distance map for the certified
    lattice prefilter: ``floor(d * BOUND_Q)`` saturating at
    :data:`BOUND_FAR` (+inf dead/tombstone rows land exactly on the
    sentinel). Floor only UNDER-states distances, so
    ``(q8 <= tol*BOUND_Q)`` is a SUPERSET of the exact ``(d <= tol)`` hit
    set for any tolerance — the quantized map yields a valid vote upper
    BOUND at a quarter of the f32 HBM read traffic (the full lattice
    scan at 1M tracks streams a 2.4 GB f32 map per query batch; the
    bound streams 0.6 GB). Derived FROM the exact map (not rebuilt from
    the DB), so incremental maintenance is 'quantize the same rows the
    f32 map just wrote'. Distances are >= 0 for any in-lattice corpus
    (the DSP floor at -417 is inside [K_MIN, K_MIN+K_SIZE)); the clip
    guards the impossible negative case conservatively (0 passes every
    tolerance — the bound can only inflate)."""
    return jnp.clip(
        jnp.floor(value_map * float(BOUND_Q)), 0.0, float(BOUND_FAR)
    ).astype(jnp.uint8)


def lattice_prefiltered_votes(
    value_map: jax.Array,
    value_map_q: jax.Array,
    q0: jax.Array,
    active: jax.Array,
    tolerance: jax.Array | float,
    band_lo: jax.Array | float,
    band_hi: jax.Array | float,
    k: int | None = None,
    top: int = 1,
    ctx_ids: jax.Array | None = None,
    ctx_id: jax.Array | int | None = None,
    k_min: int = K_MIN,
    k_size: int = K_SIZE,
):
    """CERTIFIED two-stage dialplan search: uint8 bound scan → top-k
    candidate gather → exact per-frame rescore on the f32 map.

    Same proof shape as ``match_pallas.aligned_prefiltered_votes`` (D17),
    applied to the reference's own dialplan configuration:

      votes(a) = Σ_f valid[f] · (M[a, bucket(q_f)] <= tol)      (exact)
      bound(a) = Σ_f valid[f] · (Mq[a, bucket(q_f)] <= tol·Q)   (uint8)

    ``Mq = floor(M·Q)`` under-states every distance, so each frame's
    quantized hit test is a superset of the exact one ⇒ bound >= votes
    per audio, for ANY tolerance. Rescoring the top-k audios BY BOUND is
    therefore provably exact whenever the k-th best rescored score
    strictly beats the maximum unselected bound (the certificate); the
    caller full-scans on failure. Strict > keeps the D5 lowest-index
    tiebreak exact — a certified winner cannot tie any unselected audio.

    The rescore gathers the ``[B, k, K]`` candidate ROWS of the f32 map
    (contiguous rows, not a per-(candidate, frame) element gather) and
    contracts them against the same
    query histogram as the full scan; prefilter traffic is the uint8
    bound scan (A·K bytes) + a few MB of candidate rows: a ~4x
    read-traffic reduction over the full f32 scan at any large A.

    Context filtering mirrors the aligned prefilter: out-of-context rows
    get bound −1 (never selected above a live in-context row) and any
    that ARE selected rescore to 0, so the certificate certifies the
    in-context winner against unselected in-context bounds only.

    Caller gates (engine): ``tolerance * BOUND_Q < BOUND_FAR`` (past
    saturation every row passes the bound — still valid, never certifies)
    and ``A > 2k`` (selection must be real). Dead/tombstoned rows hold
    the 255 sentinel in ``Mq`` and +inf in ``M``: never selected while
    any live row has a positive bound, zero votes if selected.

    Returns ``(votes [B, A] int32 — candidate scores scattered, zeros
    elsewhere; certificate [B] bool)``.
    """
    if k is None:
        k = LATTICE_PREFILTER_K
    has_ctx = ctx_ids is not None
    if has_ctx:
        args = (ctx_ids, jnp.asarray(ctx_id, jnp.int32))
    else:
        args = (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    return _lattice_prefiltered(
        value_map, value_map_q, q0, active,
        jnp.asarray(tolerance, jnp.float32),
        jnp.asarray(band_lo, jnp.float32),
        jnp.asarray(band_hi, jnp.float32),
        *args,
        k=int(k), top=int(top), k_min=k_min, k_size=k_size,
        has_ctx=has_ctx,
    )


# Candidate budget of the lattice prefilter. Smaller than the aligned
# prefilter's 1024: the rescore here is a tiny row-gather + matmul (not a
# kernel launch), so the pipeline cost is bound-scan + top-k selection —
# which shrinks with k — while 256 candidates still dwarf any separable
# corpus's near-tie population (non-separable ones de-certify either way
# and fall back).
LATTICE_PREFILTER_K = 256


def bound_tol_ok(specs_or_coefs, tolerance: float) -> bool:
    """Whether the uint8-quantized maps remain INFORMATIVE at this
    tolerance: the scaled threshold — ``tol·BOUND_Q`` for the dialplan
    lattice, ``(s·tol + 1)·BOUND_Q`` per aligned spec (the +1 is
    :func:`bound_votes`' quantization slack) — must stay below the
    :data:`BOUND_FAR` saturation sentinel, or every row (including
    tombstones) passes the bound — still VALID, but the certificate can
    never hold and the prefilter pipeline is pure overhead on top of the
    guaranteed full-scan fallback. Engines gate both the dialplan
    prefilter and the aligned prefilter (its :func:`bound_specs` scales)
    on this. Accepts either a
    spec tuple (aligned) or a coef count (resolved via ``bound_specs``);
    the dialplan path passes ``specs_or_coefs=None`` for the unit
    scale."""
    if tolerance < 0:
        return False
    if specs_or_coefs is None:
        # dialplan lattice: the bound thresholds at tol·BOUND_Q directly
        # (_prefilter_core — floor quantization UNDER-states distances,
        # so no +1 slack term), hence saturation at tol ≥ 255/64 ≈ 3.98
        return tolerance * BOUND_Q < BOUND_FAR
    if isinstance(specs_or_coefs, int):
        scales = tuple(s[1] for s in bound_specs(specs_or_coefs))
    else:
        scales = tuple(s[1] for s in specs_or_coefs)
    # ANY unsaturated coef keeps the min() bound informative: a
    # saturated coef contributes the active-frame count, which the min
    # simply ignores next to a tighter term (2-coef specs mix s=4 and
    # s=8, so their saturation tolerances differ — round 5)
    return any(
        (s * tolerance + 1.0) * BOUND_Q < BOUND_FAR for s in scales
    ) if scales else False


def certificate(votes_k, unselected_max, top: int = 1):
    """THE certification rule, shared by every prefiltered path (ops,
    shard_map, fused): the ``top``-th best exactly-rescored score must
    STRICTLY beat the maximum bound over unselected rows (strict >
    keeps the D5 lowest-index tiebreak exact — a certified winner cannot
    tie any unselected audio); an unselected max <= 0 certifies
    trivially (nothing unselected can appear in any result)."""
    if top == 1:
        kth = votes_k.max(axis=1)
    else:
        # top-k listings: ALL k winners must be inside the candidate set
        kth = jax.lax.top_k(votes_k, top)[0][:, -1]
    return (kth > unselected_max) | (unselected_max <= 0)


def scatter_candidates(votes_k, idx, n_rows: int):
    """Candidate scores scattered into a dense ``[B, n_rows]`` votes
    array (zeros elsewhere) — shared by the ops-level and shard-mapped
    prefilters so their output layout can never diverge."""
    b = votes_k.shape[0]
    rows_b = jnp.arange(b)[:, None]
    return jnp.zeros((b, n_rows), jnp.int32).at[rows_b, idx].max(votes_k)


def _prefilter_core(
    vm, vm_q, q0, active, tol, band_lo, band_hi, ctx_ids, ctx_id,
    k: int, k_min: int, k_size: int, has_ctx: bool,
):
    """Traced body shared by :func:`lattice_prefiltered_votes` and the
    engine's fused one-dispatch search. Returns
    ``(votes_k [B, k] int32 exact candidate scores, idx [B, k] candidate
    rows, unselected_max [B] int32 max bound over unselected rows,
    c [B, K] f32 query histogram — reusable by a full-scan fallback in
    the same program)."""
    b = q0.shape[0]
    idxq, valid = _frame_buckets(q0, active, band_lo, band_hi, k_min, k_size)
    rows_b = jnp.arange(b)[:, None]
    c = jnp.zeros((b, k_size), jnp.float32)
    c = c.at[rows_b, idxq].add(valid.astype(jnp.float32))
    # bound stage: integer-vs-integer compare is exact (u8 -> f32 lossless)
    bound = _hit_matmul(c, vm_q, tol * float(BOUND_Q))  # [B, A] int32
    if has_ctx:
        keep = ctx_ids == ctx_id
        bound = jnp.where(keep[None, :], bound, -1)
    _, idx = jax.lax.approx_max_k(
        bound.astype(jnp.float32), k, recall_target=0.99
    )  # high recall; a missed high-bound audio costs only a certificate
    # failure -> exact full-scan fallback
    unselected_max = bound.at[rows_b, idx].set(-1).max(axis=1)
    # exact rescore: CONTIGUOUS candidate-row gather from the f32 map +
    # the same histogram contraction as lattice_votes, restricted to the
    # candidate rows (votes = Σ_k C[b,k]·(M[a,k] <= tol) — identical
    # math, so parity is structural). Whole rows, not a per-(candidate,
    # frame) element gather.
    m_rows = vm[idx]  # [B, k, K] f32
    hits = (m_rows <= tol).astype(jnp.float32)
    votes_k = jnp.einsum(
        "bk,bjk->bj", c, hits, precision=jax.lax.Precision.HIGHEST
    ).astype(jnp.int32)  # exact: counts and 0/1 hits are small ints
    if has_ctx:
        votes_k = jnp.where(keep[idx], votes_k, 0)
    return votes_k, idx, unselected_max, c


@functools.partial(
    jax.jit,
    static_argnames=("k", "top", "k_min", "k_size", "has_ctx"),
)
def _lattice_prefiltered(
    vm, vm_q, q0, active, tol, band_lo, band_hi, ctx_ids, ctx_id,
    k: int, top: int, k_min: int, k_size: int, has_ctx: bool,
):
    votes_k, idx, unselected_max, _ = _prefilter_core(
        vm, vm_q, q0, active, tol, band_lo, band_hi, ctx_ids, ctx_id,
        k=k, k_min=k_min, k_size=k_size, has_ctx=has_ctx,
    )
    votes = scatter_candidates(votes_k, idx, vm.shape[0])
    return votes, certificate(votes_k, unselected_max, top)


def search_lattice(
    value_map: jax.Array,
    query: np.ndarray | jax.Array,
    n_frames: np.ndarray | jax.Array | None = None,
    tolerance: float = DEF_SEARCH_TOLERANCE,
    freq_ignore_low: int = -1,
    freq_ignore_high: int = -1,
    audio_filter: jax.Array | None = None,
    with_top1: bool = True,
):
    """Drop-in equivalent of ``match_jax.search_batch`` for the
    ``coefs=1, trunc_coef1=True`` (dialplan) path.

    Returns (best [B] int32, match_count [B] int32, votes [B, A] int32);
    ``with_top1=False`` skips the device argmax and returns
    ``(None, None, votes)`` for callers that rank on host.
    """
    if tolerance < 0:
        tolerance = DEF_SEARCH_TOLERANCE  # fp_handler.c:252-256
    q = jnp.asarray(query, dtype=jnp.float32)
    b, f, _ = q.shape
    valid = (
        jnp.ones((b, f), dtype=bool)
        if n_frames is None
        else jnp.arange(f)[None, :] < jnp.asarray(n_frames)[:, None]
    )
    lo, hi = match_jax.band_thresholds(freq_ignore_low, freq_ignore_high)
    votes = lattice_votes(
        value_map,
        q[..., 0],
        valid,
        jnp.float32(tolerance),
        jnp.float32(lo),
        jnp.float32(hi),
    )
    if not with_top1:
        return None, None, votes
    best, count = match_jax.top1(votes, audio_filter)
    return best, count, votes
