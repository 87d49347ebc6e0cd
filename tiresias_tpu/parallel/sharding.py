"""Multi-chip sharding: device mesh, sharded fingerprinting and matching.

The reference is single-process, single-node, shared-memory C (SURVEY.md §2
"Parallelism strategies": none exist to translate). The scale-out design maps
the workload onto a 2-D device mesh:

  * ``batch`` axis — data parallel: query signals / streams sharded across
    devices (the dominant axis for ingest and streaming recognition).
  * ``db`` axis — "tensor"-style parallel: the fingerprint database matrix
    ``[A, T, C]`` sharded on its audio axis, so each chip holds and scans a
    slice of a DB too large (or too latency-critical) for one device; votes
    are exchanged with one tiled ``all_gather`` (choosing gather over psum:
    each shard produces *disjoint* audio columns, so concatenation, not
    summation, is the reduction).

Everything is ``shard_map`` over ``jax.sharding.Mesh`` + XLA collectives,
which XLA hands to NCCL on GPUs. The cards of one host reach each other all
to all over NVLink, so the mesh follows the algorithm alone. Tests run on a
CPU-simulated 8-device mesh (tests/conftest.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tiresias_tpu.ops import match_jax
from tiresias_tpu.ops.mfcc_jax import dsp_constants
from tiresias_tpu.config import DEF_SEARCH_TOLERANCE, DspConfig

DB_AXIS = "db"
BATCH_AXIS = "batch"


def make_mesh(
    n_db: int | None = None,
    n_batch: int | None = None,
    devices=None,
) -> Mesh:
    """Build a ``(db, batch)`` mesh over the available devices.

    Defaults: all devices on the ``db`` axis (DB scan latency dominates a
    search), ``batch=1``.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_db is None and n_batch is None:
        n_db, n_batch = n, 1
    elif n_db is None:
        n_db = n // n_batch
    elif n_batch is None:
        n_batch = n // n_db
    if n_db * n_batch != n:
        raise ValueError(f"mesh {n_db}x{n_batch} != {n} devices")
    dev_array = np.array(devices).reshape(n_db, n_batch)
    return Mesh(dev_array, (DB_AXIS, BATCH_AXIS))


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def shard_db(mesh: Mesh, db: np.ndarray, db_mask: np.ndarray):
    """Pad the audio axis to the db-axis size and device_put with a
    ``P('db')`` sharding. Padding rows are all-masked AND hold PAD_VALUE
    (never vote in either the masked XLA matcher or the value-encoded
    fused matchers)."""
    from tiresias_tpu.ops.mfcc_jax import PAD_VALUE

    n_db = mesh.shape[DB_AXIS]
    a = db.shape[0]
    a_pad = pad_to_multiple(max(a, n_db), n_db)
    if a_pad != a:
        db = np.concatenate(
            [db, np.full((a_pad - a, *db.shape[1:]), PAD_VALUE,
                         dtype=db.dtype)], axis=0
        )
        db_mask = np.concatenate(
            [db_mask, np.zeros((a_pad - a, db_mask.shape[1]), dtype=bool)], axis=0
        )
    db_sharding = NamedSharding(mesh, P(DB_AXIS, None, None))
    mask_sharding = NamedSharding(mesh, P(DB_AXIS, None))
    return (
        jax.device_put(jnp.asarray(db), db_sharding),
        jax.device_put(jnp.asarray(db_mask), mask_sharding),
        a,
    )


@functools.partial(
    jax.jit, static_argnames=("mesh", "coefs", "audio_block", "aligned")
)
def _sharded_votes(
    mesh: Mesh,
    db: jax.Array,
    db_mask: jax.Array,
    q: jax.Array,
    active: jax.Array,
    use2: jax.Array,
    tolerance: jax.Array,
    coefs: int,
    audio_block: int,
    aligned: bool = False,
) -> jax.Array:
    """Votes ``[B, A_pad]`` computed shard-locally then gathered."""

    def shard_fn(db_s, mask_s, q_s, active_s, use2_s, tol):
        # [B_local, A_local] — each db shard scans its slice only; the
        # output stays sharded on both axes (disjoint audio columns), so no
        # collective is needed here — XLA inserts the gather lazily when the
        # caller reduces over the audio axis (top-1).
        return match_jax.match_votes(
            db_s, mask_s, q_s, active_s, use2_s, tol,
            coefs=coefs, audio_block=audio_block, aligned=aligned,
        )

    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(DB_AXIS, None, None),
            P(DB_AXIS, None),
            P(BATCH_AXIS, None, None),
            P(BATCH_AXIS, None),
            P(BATCH_AXIS, None),
            P(),
        ),
        out_specs=P(BATCH_AXIS, DB_AXIS),
    )(db, db_mask, q, active, use2, tolerance)


def sharded_search(
    mesh: Mesh,
    db: jax.Array,
    db_mask: jax.Array,
    query: np.ndarray | jax.Array,
    n_frames: np.ndarray | None = None,
    coefs: int = 1,
    tolerance: float = 0.001,
    freq_ignore_low: int = -1,
    freq_ignore_high: int = -1,
    trunc_coef1: bool = True,
    aligned: bool = False,
    n_audios: int | None = None,
    audio_block: int = match_jax.AUDIO_BLOCK,
    use_pallas: bool = False,
    interpret: bool = False,
    with_top1: bool = True,
):
    """Reference-semantics search with the DB sharded across the mesh.

    ``query [B, F, C]`` must have B divisible by the batch axis (pad with
    zero-frame queries on host). Returns (best [B], match_count [B],
    votes [B, A]). ``aligned=True`` = offset-consistent voting (PARITY D9).

    ``use_pallas=True`` runs the fused matcher per DB shard
    (:func:`sharded_votes_pallas`) instead of the GSPMD-partitioned XLA
    matcher — same result; the caller keeps the tolerance below
    ``match_pallas.PALLAS_TOL_MAX``. ``interpret=True`` (tests) runs the
    Triton kernels in the Pallas interpreter.
    """
    if tolerance < 0:
        # the -1 "use default" sentinel, same as every sibling entry point
        # (match_jax.search_batch, search_lattice, search_batch_pallas —
        # fp_handler.c:252-256); without this, |q-d| <= -1 never holds and
        # every query silently returns NOTFOUND
        tolerance = DEF_SEARCH_TOLERANCE
    q, active, use2 = match_jax.prepare_query(
        query, n_frames, freq_ignore_low, freq_ignore_high, trunc_coef1
    )
    n_batch = mesh.shape[BATCH_AXIS]
    b = q.shape[0]
    b_pad = pad_to_multiple(max(b, n_batch), n_batch)
    if b_pad != b:
        pad = b_pad - b
        q = jnp.pad(q, ((0, pad), (0, 0), (0, 0)))
        active = jnp.pad(active, ((0, pad), (0, 0)))
        use2 = jnp.pad(use2, ((0, pad), (0, 0)))
    if use_pallas:
        votes = sharded_votes_pallas(
            mesh, db, q, active, use2, tolerance,
            coefs=coefs, aligned=aligned, interpret=interpret,
        )
    else:
        votes = _sharded_votes(
            mesh, db, db_mask, q, active, use2,
            jnp.asarray(tolerance, dtype=jnp.float32), coefs, audio_block,
            aligned,
        )
    votes = votes[:b]
    if n_audios is not None:
        votes = votes[:, :n_audios]
    if not with_top1:
        return None, None, votes
    best, count = match_jax.top1(votes)
    return best, count, votes


def sharded_votes_pallas(
    mesh: Mesh,
    db: jax.Array,
    q: jax.Array,
    active: jax.Array,
    use2: jax.Array,
    tolerance: float,
    coefs: int = 1,
    aligned: bool = False,
    interpret: bool = False,
) -> jax.Array:
    """Fused matcher per DB shard under shard_map.

    Each device runs :func:`tiresias_tpu.ops.match_pallas.fused_votes`
    (bag, or with ``aligned=True`` the offset-consistent PARITY.md D9
    accuracy mode) on its slice of the audio axis; vote
    columns stay disjoint (out spec ``P(batch, db)``), so no collective is
    needed until the caller's top-1. Aligned scores are per-audio maxima
    over offsets, so db-sharding commutes with them exactly like bag
    counts. Requires ``db [A, T, C]`` sharded on A with A divisible by the
    db axis and queries replicated or batch-sharded with B divisible by
    batch.
    """
    return _sharded_votes_pallas_fn(mesh, coefs, aligned, interpret)(
        db, q, active, use2, jnp.float32(tolerance)
    )


@functools.lru_cache(maxsize=128)
def _sharded_votes_pallas_fn(
    mesh: Mesh, coefs: int, aligned: bool, interpret: bool
):
    """Jitted shard_map program for :func:`sharded_votes_pallas`, cached
    per (mesh, coefs, aligned, interpret) — the fused sharded matcher sits
    on the engine's per-request search path, where rebuilding the closure
    and re-tracing the shard_map on every call (unlike the module-level
    jitted ``_sharded_votes``) would burn milliseconds per view."""
    from tiresias_tpu.ops.match_pallas import fused_votes

    def shard_fn(db_s, q_s, act_s, u2_s, tol):
        return fused_votes(
            db_s, q_s, act_s, u2_s, tol, coefs=coefs, aligned=aligned,
            interpret=interpret,
        )

    return jax.jit(
        shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(
                P(DB_AXIS, None, None),
                P(BATCH_AXIS, None, None),
                P(BATCH_AXIS, None),
                P(BATCH_AXIS, None),
                P(),
            ),
            out_specs=P(BATCH_AXIS, DB_AXIS),
            # pallas_call outputs carry no varying-mesh-axes metadata; the
            # out_specs fully describe the (disjoint-column) layout
            check_vma=False,
        )
    )


def sharded_aligned_prefiltered(
    mesh: Mesh,
    db: jax.Array,
    maps: tuple,
    q: jax.Array,
    active: jax.Array,
    use2: jax.Array,
    tolerance: float,
    specs: tuple,
    coefs: int,
    interpret: bool = False,
    ctx_ids: jax.Array | None = None,
    ctx_id: int | None = None,
    top: int = 1,
    k: int | None = None,
    aligned: bool = True,
):
    """Certified two-stage aligned (or strict-bag, ``aligned=False``)
    search per DB shard under shard_map
    (:func:`tiresias_tpu.ops.match_pallas.aligned_prefiltered_votes` run
    on each chip's slice of the audio axis).

    Exactness composes across shards exactly like the full-scan sharded
    matchers: vote columns are disjoint (out spec ``P(batch, db)``), each
    shard's certificate covers ITS rows (its winner is rescored exactly
    and strictly beats every unselected bound in the shard), and the
    caller's cross-shard top-1/top-k compares exact values — so when
    EVERY shard certifies, the combined result equals the full scan. Any
    shard's failure must fall back to the full scan for the whole view
    (the caller checks ``certs.all()``).

    ``q``/``active``/``use2`` are prepared queries (match_jax.prepare_query)
    with B divisible by the mesh batch axis (pad with zero-frame queries —
    they certify trivially). Returns (votes [B, A], certs [B, n_db] bool).
    """
    fn = _sharded_prefiltered_fn(
        mesh, specs, coefs, bool(interpret), len(maps),
        ctx_ids is not None, top, k, bool(aligned),
    )
    args = (db, *maps, q, active, use2, jnp.float32(tolerance))
    if ctx_ids is not None:
        args += (ctx_ids, jnp.int32(ctx_id))
    return fn(*args)


@functools.lru_cache(maxsize=64)
def _sharded_prefiltered_fn(
    mesh: Mesh, specs: tuple, coefs: int, interpret: bool,
    n_maps: int, has_ctx: bool, top: int, k: int | None = None,
    aligned: bool = True,
):
    """Jitted shard_map program for :func:`sharded_aligned_prefiltered`,
    cached per parameterization (per-request path — see
    :func:`_sharded_votes_pallas_fn` for why)."""
    from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

    def shard_fn(db_s, *rest):
        maps_s = tuple(rest[:n_maps])
        q_s, act_s, u2_s, tol = rest[n_maps:n_maps + 4]
        ci_s = rest[n_maps + 4] if has_ctx else None
        cid = rest[n_maps + 5] if has_ctx else None
        kw = {} if k is None else {"k": k}
        votes_s, cert_s = aligned_prefiltered_votes(
            db_s, maps_s, q_s, act_s, u2_s, tol, specs=specs,
            coefs=coefs, interpret=interpret, aligned=aligned,
            ctx_ids=ci_s, ctx_id=cid, top=top, **kw,
        )
        # one cert column per shard; the caller ANDs across shards
        return votes_s, cert_s[:, None]

    in_specs = (
        P(DB_AXIS, None, None),                     # db rows
        *([P(DB_AXIS, None)] * n_maps),             # bound-map rows
        P(BATCH_AXIS, None, None),                  # q
        P(BATCH_AXIS, None),                        # active
        P(BATCH_AXIS, None),                        # use2
        P(),                                        # tolerance
    )
    if has_ctx:
        in_specs += (P(DB_AXIS), P())               # ctx_ids rows, ctx_id
    return jax.jit(
        shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=(P(BATCH_AXIS, DB_AXIS), P(BATCH_AXIS, DB_AXIS)),
            # pallas_call outputs carry no varying-mesh-axes metadata; the
            # out_specs fully describe the disjoint-column layout
            check_vma=False,
        )
    )


def sharded_lattice_prefiltered(
    mesh: Mesh,
    vm: jax.Array,
    vm_q: jax.Array,
    q0: jax.Array,
    active: jax.Array,
    tolerance: float,
    band_lo: float,
    band_hi: float,
    ctx_ids: jax.Array | None = None,
    ctx_id: int | None = None,
    k: int | None = None,
    top: int = 1,
):
    """Certified two-stage DIALPLAN search per DB shard under shard_map
    (:func:`tiresias_tpu.ops.match_lattice.lattice_prefiltered_votes` run
    on each chip's slice of the distance-map rows — PARITY D19).

    Exactness composes across shards exactly like
    :func:`sharded_aligned_prefiltered`: vote columns are disjoint
    (out spec ``P(batch, db)``), each shard's certificate covers ITS rows,
    and the caller's cross-shard top-1/top-k compares exact values — so
    when EVERY shard certifies, the combined result equals the GSPMD full
    scan. Any shard's failure must fall back for the whole view (the
    caller checks ``certs.all()``). Pure XLA — no kernel involved.

    ``q0``/``active`` must have B divisible by the mesh batch axis (pad
    with zero-frame queries — they certify trivially). Returns
    ``(votes [B, A], certs [B, n_db] bool)``.
    """
    from tiresias_tpu.ops.match_lattice import LATTICE_PREFILTER_K

    fn = _sharded_lattice_pf_fn(
        mesh, int(k or LATTICE_PREFILTER_K), int(top), ctx_ids is not None
    )
    args = (
        vm, vm_q, q0, active, jnp.float32(tolerance),
        jnp.float32(band_lo), jnp.float32(band_hi),
    )
    if ctx_ids is not None:
        args += (ctx_ids, jnp.int32(ctx_id))
    return fn(*args)


@functools.lru_cache(maxsize=64)
def _sharded_lattice_pf_fn(mesh: Mesh, k: int, top: int, has_ctx: bool):
    """Jitted shard_map program for :func:`sharded_lattice_prefiltered`,
    cached per parameterization."""
    from tiresias_tpu.ops.match_lattice import (
        K_MIN,
        K_SIZE,
        _prefilter_core,
        certificate,
        scatter_candidates,
    )

    def shard_fn(vm_s, vmq_s, q_s, act_s, tol, lo, hi, *ctx):
        ci = ctx[0] if has_ctx else None
        cid = ctx[1] if has_ctx else None
        votes_k, idx, unsel, _ = _prefilter_core(
            vm_s, vmq_s, q_s, act_s, tol, lo, hi, ci, cid,
            k=k, k_min=K_MIN, k_size=K_SIZE, has_ctx=has_ctx,
        )
        votes = scatter_candidates(votes_k, idx, vm_s.shape[0])
        cert = certificate(votes_k, unsel, top)
        # one cert column per shard; the caller ANDs across shards
        return votes, cert[:, None]

    in_specs = (
        P(DB_AXIS, None),   # f32 distance-map rows
        P(DB_AXIS, None),   # uint8 bound-map rows
        P(BATCH_AXIS, None),  # q0
        P(BATCH_AXIS, None),  # active
        P(), P(), P(),      # tolerance, band_lo, band_hi
    )
    if has_ctx:
        in_specs += (P(DB_AXIS), P())  # ctx_ids rows, ctx_id
    return jax.jit(
        shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=(P(BATCH_AXIS, DB_AXIS), P(BATCH_AXIS, DB_AXIS)),
        )
    )


def sharded_fingerprint_long(
    mesh: Mesh,
    pcm: np.ndarray | jax.Array,
    samplerate: int,
    dsp: DspConfig | None = None,
) -> jax.Array:
    """Sequence-parallel fingerprint of ONE long signal: the frame axis is
    sharded across every device with a halo exchange of the window overlap.

    MFCC frames are independent given ``buf_size`` samples of context
    (SURVEY.md §5 long-context note), so the only communication is one
    ``ppermute`` shipping each shard's last ``buf_size − hop_size`` samples
    (256 at the reference's parameters) to its right neighbor — the
    sequence-parallel analogue of a ring halo exchange.

    Args:
      pcm: ``[S]`` with S a multiple of ``hop_size × n_devices``.
    Returns:
      ``[F, n_coefs]`` with F = S // hop_size, identical to the
      single-device result.
    """
    dsp = dsp or DspConfig()
    window, mel_t, dct_t = dsp_constants(dsp, int(samplerate))
    n = mesh.devices.size
    pcm = jnp.asarray(pcm, dtype=jnp.float32)
    (s,) = pcm.shape
    if s % (dsp.hop_size * n) != 0:
        raise ValueError(
            f"signal length {s} must be a multiple of hop*devices "
            f"({dsp.hop_size}*{n})"
        )
    overlap = dsp.buf_size - dsp.hop_size
    if s // n < overlap:
        # each shard ships its LAST `overlap` samples right; a shorter
        # local slice would silently truncate the halo and fail deep in
        # the shard_map reshape with an opaque shape error
        raise ValueError(
            f"per-shard slice {s // n} is shorter than the window overlap "
            f"{overlap} (buf_size-hop_size); use a longer signal or fewer "
            "devices"
        )
    axes = (DB_AXIS, BATCH_AXIS)

    def shard_fn(chunk, w, m, d):
        # chunk: [1, S_local]. Ship our tail right; shard 0 gets zeros
        # (the pvoc zero-initialised buffer, reference_dsp framing).
        tail = chunk[:, -overlap:]
        idx = jax.lax.axis_index(axes)
        halo = jax.lax.ppermute(
            tail, axes, [(i, (i + 1) % n) for i in range(n)]
        )
        halo = jnp.where(idx == 0, jnp.zeros_like(halo), halo)
        ext = jnp.concatenate([halo, chunk], axis=1)  # [1, overlap+S_local]
        # frame i covers ext[i*hop : i*hop + win) — same sliding window as
        # frames_from_pcm but with real left context instead of zeros
        f_loc = chunk.shape[1] // dsp.hop_size
        k = dsp.buf_size // dsp.hop_size
        chunks = ext[:, overlap:].reshape(1, f_loc, dsp.hop_size)
        parts = []
        for back in range(k - 1, -1, -1):
            if back == 0:
                parts.append(chunks)
            else:
                lead = ext[
                    :, overlap - back * dsp.hop_size : overlap
                ].reshape(1, back, dsp.hop_size)
                shifted = jnp.concatenate(
                    [lead, chunks[:, :-back, :]], axis=1
                )
                parts.append(shifted)
        frames = jnp.concatenate(parts, axis=-1)  # [1, F_loc, win]
        # the shared parity-sensitive chain — drift vs the single-device
        # fingerprint is impossible by construction
        from tiresias_tpu.ops.mfcc_jax import coef_scale_for, spectral_chain

        out = spectral_chain(frames, w, m, d)
        cw = coef_scale_for(dsp)  # round-5 noise weighting
        return out if cw is None else out * jnp.asarray(cw)

    out = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(None, axes), P(), P(), P()),
        out_specs=P(None, axes, None),
    )(
        pcm[None, :],
        jnp.asarray(window),
        jnp.asarray(mel_t),
        jnp.asarray(dct_t),
    )
    return out[0]


def sharded_fingerprint(
    mesh: Mesh,
    pcm_padded: np.ndarray | jax.Array,
    samplerate: int,
    dsp: DspConfig | None = None,
    law: str | None = None,
    n_valid: np.ndarray | jax.Array | None = None,
) -> jax.Array:
    """Data-parallel fingerprinting: signals sharded on the batch axis.

    The frame axis is embarrassingly parallel (SURVEY.md §5 long-context
    note), so sharding whole signals across chips needs no halo exchange;
    ``pcm_padded [B, S]`` with B divisible by the mesh's total device count
    (the db axis is folded into batch for ingest — all chips fingerprint).

    ``law``/``n_valid``: G.711 wire batches (uint8 codes, one byte per
    sample over the link) expand on device per shard, with decoded
    padding zeroed exactly like the single-device path
    (ops.mfcc_jax.mask_valid_samples — PARITY D18 bit-parity holds
    per shard).
    """
    from tiresias_tpu.ops.mfcc_jax import (
        _fingerprint_padded,
        coef_scale_for,
        mask_valid_samples,
        to_float_pcm,
    )

    dsp = dsp or DspConfig()
    window, mel_t, dct_t = dsp_constants(dsp, int(samplerate))
    n_total = mesh.devices.size
    # keep the WIRE dtype across the shards: int16 ships at half the
    # bytes, G.711 uint8 at a quarter, both scaled/expanded on device
    # (to_float_pcm — the same rule as the single-device
    # fingerprint_padded_batch; a bare float32 cast would feed
    # 32768x-scaled samples to the DSP)
    pcm = jnp.asarray(pcm_padded)
    if pcm.dtype == jnp.uint8 and law is None:
        raise ValueError("uint8 PCM requires a G.711 law (pass law=...)")
    if pcm.dtype not in (jnp.int16, jnp.uint8, jnp.float32):
        pcm = pcm.astype(jnp.float32)
    if pcm.shape[0] % n_total != 0:
        raise ValueError(f"batch {pcm.shape[0]} not divisible by {n_total} devices")
    nv = (
        jnp.asarray(n_valid, jnp.int32)
        if n_valid is not None
        else jnp.full((pcm.shape[0],), pcm.shape[1], jnp.int32)
    )

    cw = coef_scale_for(dsp)  # round-5 noise weighting (None = parity)

    def shard_fn(pcm_s, nv_s, w, m, d):
        x = mask_valid_samples(to_float_pcm(pcm_s, law), nv_s)
        out = _fingerprint_padded(x, w, m, d, dsp.hop_size, dsp.buf_size)
        return out if cw is None else out * jnp.asarray(cw)

    flat = P((DB_AXIS, BATCH_AXIS), None)
    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(flat, P((DB_AXIS, BATCH_AXIS)), P(), P(), P()),
        out_specs=P((DB_AXIS, BATCH_AXIS), None, None),
    )(pcm, nv, jnp.asarray(window), jnp.asarray(mel_t), jnp.asarray(dct_t))
