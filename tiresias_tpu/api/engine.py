"""Library API: the :class:`Tiresias` engine.

Mirrors the reference's public surface — the 12 ``fp_*`` functions
(/root/reference/src/fp_handler.h:13-38) plus the ``Tiresias()`` dialplan
application's result contract (the seven ``TIR*`` channel variables,
/root/reference/src/application_handler.c:166-234) — as one engine object:

    eng = Tiresias(config)
    eng.sync()                                   # init_context/init_audio
    res = eng.search_file("ctx", "query.wav")    # Tiresias() dialplan app
    res.status, res.name, res.match_count, ...   # TIR* variables

Lifecycle mirrors load/unload (/root/reference/src/app_tiresias.c:66-149):
construction restores the checkpoint (fp_init, fp_handler.c:80-87);
:meth:`close` persists it (fp_term, :97-103) — plus crash-safe checkpoints
after every ingest batch (PARITY.md D2).
"""

from __future__ import annotations

import dataclasses
import functools as _functools
import os
import threading

import numpy as np

from tiresias_tpu.config import (
    DEF_DURATION_MS,
    DEF_SEARCH_TOLERANCE,
    DspConfig,
    MatchConfig,
    TiresiasConfig,
)
from tiresias_tpu.engine.sync import SyncReport, ingest_files, sync_all
from tiresias_tpu.ops import match_jax
from tiresias_tpu.ops.mfcc_jax import (
    fingerprint_signal,
    fingerprint_signals_async,
)
from tiresias_tpu.store.fingerprint_store import AudioEntry, FingerprintStore
from tiresias_tpu.utils.audio import read_audio
from tiresias_tpu.utils.hashing import file_md5
from tiresias_tpu.utils.logging import get_logger
from tiresias_tpu.utils.tracing import metrics, phase

log = get_logger(__name__)

# TIRSTATUS values (/root/reference/src/application_handler.c:168,173,189,193)
STATUS_FOUND = "FOUND"
STATUS_NOTFOUND = "NOTFOUND"
STATUS_HANGUP = "HANGUP"


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """The TIR* contract as a result object
    (/root/reference/src/application_handler.c:193-234 and
    /root/reference/doc/dialplan_application.rst:24-46)."""

    status: str  # TIRSTATUS
    frame_count: int  # TIRFRAMECOUNT — all query frames, incl. band-skipped
    match_count: int  # TIRMATCHCOUNT — votes of the winner
    uuid: str | None = None  # TIRFILEUUID
    name: str | None = None  # TIRFILENAME
    context: str | None = None  # TIRCONTEXT
    hash: str | None = None  # TIRFILEHASH
    # per-channel window index (continuous streaming): the serve layer
    # pipelines score passes, so results MAY arrive out of order — this
    # monotone counter lets clients reorder (not part of the TIR* contract)
    window: int = 0

    @property
    def found(self) -> bool:
        return self.status == STATUS_FOUND

    @property
    def confidence(self) -> float:
        """match_count / frame_count — the doc's suggested confidence measure
        (/root/reference/doc/dialplan_application.rst:40-46)."""
        return self.match_count / self.frame_count if self.frame_count else 0.0

    def to_channel_vars(self) -> dict[str, str]:
        """Render as the literal TIR* variable dict the dialplan app sets."""
        out = {
            "TIRSTATUS": self.status,
            "TIRFRAMECOUNT": str(self.frame_count),
            "TIRMATCHCOUNT": str(self.match_count),
        }
        if self.found:
            out.update(
                TIRFILEUUID=self.uuid or "",
                TIRFILENAME=self.name or "",
                TIRCONTEXT=self.context or "",
                TIRFILEHASH=self.hash or "",
            )
        return out


NOT_FOUND = SearchResult(status=STATUS_NOTFOUND, frame_count=0, match_count=0)


def parse_dialplan_args(argstring: str) -> dict:
    """Parse the literal ``Tiresias()`` dialplan argument string:
    ``<context>,<duration>,[tolerance],[freq_ignore_low],[freq_ignore_high]``
    (/root/reference/src/application_handler.c:81-137;
    /root/reference/doc/dialplan_application.rst). Empty/absent optional
    fields fall back to config defaults, exactly like the reference
    (tolerance < 0 → default; duration <= 0 → 3000 ms)."""
    parts = [p.strip() for p in argstring.split(",")]
    if not parts or not parts[0]:
        raise ValueError("context name required (application_handler.c:99-104)")
    out: dict = {"context": parts[0]}
    if len(parts) > 1 and parts[1]:
        out["duration_ms"] = int(parts[1])
    if len(parts) > 2 and parts[2]:
        out["tolerance"] = float(parts[2])
    if len(parts) > 3 and parts[3]:
        out["freq_ignore_low"] = int(parts[3])
    if len(parts) > 4 and parts[4]:
        out["freq_ignore_high"] = int(parts[4])
    return out


@_functools.lru_cache(maxsize=16)
def _fused_lattice_fn(
    dsp: DspConfig, samplerate: int, law: str | None = None,
    prefilter: bool = False, k: int = 0,
):
    """One-dispatch dialplan search: fingerprint → lattice votes → top-1
    with the D5 lowest-insertion-index tiebreak, all on device.

    Single-tier stores only, where view row order == global insertion
    order, so the tiebreak key is just the row index. This collapses three
    dispatches and host round trips into one; results are identical to
    the staged path (same kernels, same tiebreak).

    ``prefilter=True`` (large stores — the caller gates on size and
    tolerance) runs the certified two-stage search INSIDE the same
    dispatch: uint8 bound scan → exact f32 rescore of the top-K
    candidates, with a ``lax.cond`` full scan when any query's
    certificate fails — so even the fallback costs one dispatch, and the
    certified case never streams the full f32 map (a quarter of the read
    traffic at 1M tracks; PARITY D19). The certified winner strictly
    beats every unselected bound, so the lowest-row tiebreak among
    candidates equals the full scan's."""
    import jax
    import jax.numpy as jnp

    from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch

    def _top1(votes, m):
        # among max-vote rows, the lowest row index (insertion order);
        # padded rows can never hold votes > 0 (their lattice map is empty)
        big = jnp.int32(2**30)
        cand = jnp.where(
            votes == m[:, None], jnp.arange(votes.shape[1]), big
        )
        return jnp.where(m > 0, jnp.min(cand, axis=1), -1).astype(jnp.int32)

    if prefilter:
        from tiresias_tpu.ops.match_lattice import (
            K_MIN,
            K_SIZE,
            _hit_matmul,
            _prefilter_core,
            certificate,
        )

        @jax.jit
        def run(pcm, n_frames, vm, vm_q, tol, band_lo, band_hi, ci=None,
                cid=None, n_valid=None):
            qfp = fingerprint_padded_batch(
                pcm, samplerate, dsp, law=law, n_valid=n_valid
            )
            f = qfp.shape[1]
            valid = jnp.arange(f)[None, :] < n_frames[:, None]
            q0 = qfp[..., 0]
            votes_k, idx, unsel_max, c = _prefilter_core(
                vm, vm_q, q0, valid, tol, band_lo, band_hi, ci, cid,
                k=k, k_min=K_MIN, k_size=K_SIZE,
                has_ctx=ci is not None,
            )
            m_k = votes_k.max(axis=1)
            certified = certificate(votes_k, unsel_max).all()

            def pre(_):
                big = jnp.int32(2**30)
                cand = jnp.where(votes_k == m_k[:, None], idx, big)
                best = jnp.where(
                    m_k > 0, jnp.min(cand, axis=1), -1
                ).astype(jnp.int32)
                return best, m_k

            def full(_):
                # the core already built the query histogram for the
                # bound matmul — reuse it instead of re-scattering
                votes = _hit_matmul(c, vm, tol)
                if ci is not None:
                    votes = jnp.where((ci == cid)[None, :], votes, 0)
                m = jnp.max(votes, axis=1)
                return _top1(votes, m), m

            best, m = jax.lax.cond(certified, pre, full, operand=None)
            # the certificate rides the same readback: the engine's
            # adaptive gate (_pf_note) needs the outcome
            return best, m, certified

        return run

    from tiresias_tpu.ops.match_lattice import lattice_votes

    @jax.jit
    def run(pcm, n_frames, vm, tol, band_lo, band_hi, ci=None, cid=None,
            n_valid=None):
        qfp = fingerprint_padded_batch(
            pcm, samplerate, dsp, law=law, n_valid=n_valid
        )
        f = qfp.shape[1]
        valid = jnp.arange(f)[None, :] < n_frames[:, None]
        votes = lattice_votes(vm, qfp[..., 0], valid, tol, band_lo, band_hi)
        if ci is not None:  # context filter: see _top1_scored
            votes = jnp.where((ci == cid)[None, :], votes, 0)
        m = jnp.max(votes, axis=1)
        return _top1(votes, m), m

    return run


@_functools.lru_cache(maxsize=16)
def _fused_strict_fn(
    dsp: DspConfig, samplerate: int, law: str | None, coefs: int,
    aligned: bool, k: int, lo: int, hi: int, specs: tuple,
    prefilter: bool = True, top2: bool = False,
):
    """One-dispatch STRICT (no-truncation) multicoef search: fingerprint
    → certified two-stage prefilter (lattice bounds → exact fused
    rescore, bag or aligned) → top-1, with a ``lax.cond`` full fused
    scan when any certificate fails — all inside one jit program.

    ``prefilter=False`` builds the same one-dispatch program WITHOUT the
    bound stage (fingerprint → full fused scan → top-1): small stores,
    bound-saturating tolerances, and never-certifying corpora (adaptive
    gate closed) still collapse the staged path's 3-4 dispatches and
    host round trips into one.

    The strict config is the reference's own coefs=2 library
    configuration (/root/reference/src/fp_handler.c:247-250,321).
    Single-tier stores only (row index == insertion order, same tiebreak
    argument as :func:`_fused_lattice_fn`)."""
    import jax
    import jax.numpy as jnp

    from tiresias_tpu.ops import match_jax as mj
    from tiresias_tpu.ops.match_pallas import (
        aligned_prefiltered_votes,
        fused_votes,
    )
    from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch

    def _top1_rows(votes):
        # among max-vote rows, the lowest row index == insertion order
        m = jnp.max(votes, axis=1)
        big = jnp.int32(2**30)
        cand = jnp.where(votes == m[:, None], jnp.arange(votes.shape[1]), big)
        best = jnp.where(m > 0, jnp.min(cand, axis=1), -1).astype(jnp.int32)
        if not top2:
            return best, m
        # runner-up AUDIO's votes (margin acceptance): max outside the
        # winning row. With the prefilter this is exact because the
        # certificate is taken at top=2 (every audio reaching the
        # 2nd-best score is a candidate with its exact score)
        rows = jnp.arange(votes.shape[1])[None, :]
        m2 = jnp.max(
            jnp.where(rows == best[:, None], jnp.int32(-1), votes), axis=1
        )
        return best, m, jnp.maximum(m2, 0)

    def _prep(pcm, n_frames, n_valid):
        qfp = fingerprint_padded_batch(
            pcm, samplerate, dsp, law=law, n_valid=n_valid
        )
        return mj.prepare_query(qfp, n_frames, lo, hi, trunc_coef1=False)

    def _full_votes(db, q, active, use2, tol, ci, cid):
        votes = fused_votes(
            db, q, active, use2, tol, coefs=coefs, aligned=aligned
        )
        if ci is not None:
            votes = jnp.where((ci == cid)[None, :], votes, 0)
        return votes

    if not prefilter:
        @jax.jit
        def run_full(pcm, n_frames, db, tol, ci=None, cid=None,
                     n_valid=None):
            q, active, use2 = _prep(pcm, n_frames, n_valid)
            return _top1_rows(
                _full_votes(db, q, active, use2, tol, ci, cid)
            )

        return run_full

    @jax.jit
    def run(pcm, n_frames, db, maps, tol, ci=None, cid=None, n_valid=None):
        q, active, use2 = _prep(pcm, n_frames, n_valid)
        votes_pf, cert = aligned_prefiltered_votes(
            db, maps, q, active, use2, tol, specs=specs, coefs=coefs,
            k=k, aligned=aligned,
            ctx_ids=ci, ctx_id=cid, top=2 if top2 else 1,
        )
        certified = cert.all()

        def pre(_):
            return _top1_rows(votes_pf)

        def full(_):
            return _top1_rows(
                _full_votes(db, q, active, use2, tol, ci, cid)
            )

        outs = jax.lax.cond(certified, pre, full, operand=None)
        # the certificate rides the same readback: the engine's adaptive
        # gate (_pf_note) needs the outcome
        return (*outs, certified)

    return run


def _top1_scored(votes, seq, ctx_ids=None, ctx_id=None):
    """Per-view device top-1 with the D5 tiebreak: maximize votes, tie →
    lowest global insertion seq.

    Pure int32 on device (JAX's default disables x64; a packed 64-bit score
    would silently truncate). Padding/tombstone-beyond-view rows carry
    seq = int32.max (store.seq_for) and 0 votes, so they can never beat a
    live row at votes > 0. ``ctx_ids``/``ctx_id`` (store.ctx_ids_for /
    ctx_id_for) zero out-of-context votes inside the same dispatch, so
    context-filtered searches keep the O(B) readback.

    Returns (votes [B] int32, seq [B] int32, row [B] int32) — three
    vectors instead of the full [B, A] votes matrix crossing the link;
    the cross-view lexicographic combine happens on host in int64."""
    global _top1_scored_fn
    if _top1_scored_fn is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def run(v, s, ci, cid):
            if ci is not None:
                v = jnp.where((ci == cid)[None, :], v, 0)
            m = jnp.max(v, axis=1)  # [B] winning vote count
            # among max-vote rows: the lowest seq, and its row (argmin
            # returns the first minimal seq — seqs are unique)
            cand = jnp.where(v == m[:, None], s[None, :], jnp.int32(2**31 - 1))
            i = jnp.argmin(cand, axis=1).astype(jnp.int32)
            rows = jnp.arange(v.shape[0])
            return m, cand[rows, i], i

        _top1_scored_fn = run
    return _top1_scored_fn(votes, seq, ctx_ids, ctx_id)


_top1_scored_fn = None


@_functools.lru_cache(maxsize=64)
def _topk_scored_fn(k: int):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(v, s, ci, cid):
        if ci is not None:  # context filter: see _top1_scored
            v = jnp.where((ci == cid)[None, :], v, 0)
        tv, ti = jax.lax.top_k(v, k)  # ties → lower row index, which IS
        # per-tier insertion order (append-only rows, order-preserving
        # compaction) — so each view's k candidates are its exact
        # lexicographic (votes desc, seq asc) top-k
        return tv, jnp.take(s, ti), ti.astype(jnp.int32)

    return run


class Tiresias:
    """Accelerator-native audio fingerprinting engine (the framework's front
    door)."""

    def __init__(
        self,
        config: TiresiasConfig | None = None,
        restore: bool = True,
        mesh=None,
        exclusive: bool | None = None,
    ) -> None:
        """``mesh``: optional ``jax.sharding.Mesh`` with a ``db`` axis; the
        fingerprint DB is then sharded across its devices and every search
        auto-partitions via GSPMD (see store.device_db). Pass the string
        ``"auto"`` to shard across all local devices when more than one is
        present (single-device hosts stay unsharded), or ``"global"`` to
        shard over ALL devices of a multi-host deployment (requires
        ``parallel.initialize_distributed()`` first; every process must
        construct the engine identically — docs/distributed.md).

        ``exclusive``: single-writer ownership of the data directory
        (utils.locking). ``True`` — must own it; raises
        :class:`tiresias_tpu.utils.locking.DataDirLocked` if another live
        process (e.g. a running ``tiresias serve``) holds it. ``None``
        (default) — try to own it; fall back to a READ-ONLY engine with a
        warning when it is held (searches work, :meth:`save` raises).
        ``False`` — read-only by choice (listing/search tools)."""
        from tiresias_tpu.utils.compile_cache import enable_compilation_cache
        from tiresias_tpu.utils.locking import DataDirLock, DataDirLocked

        enable_compilation_cache()
        self.config = config or TiresiasConfig()
        # serializes sync/reload against each other (e.g. a serve watcher
        # tick racing an admin-plane sync): both walk the same directories
        # and the reconcile is only idempotent when runs don't interleave
        self._sync_mutex = threading.Lock()
        # adaptive prefilter gate state: (view.gen, mode) -> consecutive
        # certificate misses, least-recently-noted first (see _pf_note);
        # its own lock — searches run on serve executor threads
        self._pf_misses: dict = {}
        self._pf_lock = threading.Lock()
        # G.711 laws whose device programs warmup_async is still
        # compiling, COUNTED per law (law_device_ready; the scorer
        # host-decodes those). Counters, not a set: overlapping
        # warmup_async calls must not let the first thread's cleanup
        # un-park a law the second call just re-registered.
        self._laws_warming: dict = {}
        self._warm_lock = threading.Lock()
        self._warm_stop = threading.Event()
        self._warm_threads: list = []
        self.lock = DataDirLock(self.config.expanded_data_dir)
        if exclusive is not False:
            try:
                self.lock.acquire()
            except DataDirLocked as exc:
                # ONLY contention degrades to read-only; filesystem errors
                # (permissions, read-only mounts) must surface as themselves
                if exclusive:
                    raise
                log.warning("engine is read-only: %s", exc)
        try:
            if mesh == "auto":
                import jax

                from tiresias_tpu.parallel import make_mesh

                devices = jax.local_devices()  # only addressable devices
                mesh = (
                    make_mesh(len(devices), 1, devices=devices)
                    if len(devices) > 1
                    else None
                )
            elif mesh == "global":
                import jax

                from tiresias_tpu.parallel import global_mesh

                mesh = global_mesh() if len(jax.devices()) > 1 else None
            self.mesh = mesh
            self.checkpoint_dir = os.path.join(
                self.config.expanded_data_dir, "checkpoint"
            )
            if restore:
                self.store = FingerprintStore.load(
                    self.checkpoint_dir, n_coefs=self.config.dsp.n_coefs,
                    mesh=mesh, coef_weights=self.config.dsp.coef_weights,
                )
            else:
                self.store = FingerprintStore(
                    n_coefs=self.config.dsp.n_coefs, mesh=mesh,
                    coef_weights=self.config.dsp.coef_weights,
                )
            for ctx in self.config.contexts:
                self.store.create_context(ctx.name, ctx.directory)
        except BaseException:
            # a failed construction (unreadable checkpoint, bad context)
            # must not leave the data-dir flock held by a dead engine: a
            # same-process retry after repairing the checkpoint would be
            # locked out by its own leaked fd (flock treats fds
            # independently) until process exit
            self.lock.release()
            raise

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def sync(self) -> SyncReport:
        """Reconcile store with config + filesystem (init_context/init_audio,
        /root/reference/src/app_tiresias.c:230-358). Requires data-dir
        ownership — sync checkpoints after each context's ingest."""
        if not self.lock.held:
            from tiresias_tpu.utils.locking import DataDirLocked

            raise DataDirLocked(
                self.config.expanded_data_dir, self.lock.owner_info()
            )
        with self._sync_mutex, phase("engine.sync"):
            return sync_all(self.store, self.config, self.checkpoint_dir,
                            mesh=self._ingest_mesh())

    def _ingest_mesh(self):
        """Mesh for data-parallel ingest fingerprinting: the engine's mesh
        when every device is addressable by this process. Multi-controller
        deployments return None — each process ingests its own files on
        its default device (host-local inputs cannot form the global
        arrays a cross-process shard_map needs)."""
        if self.mesh is None:
            return None
        import jax

        local = jax.process_index()
        if any(
            d.process_index != local for d in self.mesh.devices.flat
        ):
            return None
        return self.mesh

    def sync_context(self, context: str) -> SyncReport:
        """Per-context directory re-sync + checkpoint (the admin plane's
        and CLI's ``create <context>`` op). Serializes with full syncs —
        a watch tick walking the same directory concurrently could
        otherwise delete an audio this call just ingested (its stale
        disk-hash snapshot predates the file) or fingerprint the same
        file twice. Raises ValueError for an unknown/directory-less
        context."""
        if not self.lock.held:
            from tiresias_tpu.utils.locking import DataDirLocked

            raise DataDirLocked(
                self.config.expanded_data_dir, self.lock.owner_info()
            )
        from tiresias_tpu.engine.sync import sync_context_audio

        ctx = self.store.get_context(context)
        if ctx is None or not ctx["directory"]:
            raise ValueError(f"unknown context {context!r}")
        with self._sync_mutex, phase("engine.sync"):
            report = sync_context_audio(
                self.store, context, ctx["directory"], self.config.dsp,
                mesh=self._ingest_mesh(),
            )
            self.save()
            return report

    def refresh_from_checkpoint(self) -> bool:
        """Re-read the checkpoint and atomically swap in the new store
        when the OWNER committed a newer generation — the read-only
        REPLICA's follow path (``tiresias serve --replica --follow N``).

        The owner checkpoints after every mutation; replicas poll this.
        Generation comparison is a cheap catalog-metadata read (no
        fingerprint deserialization when nothing changed). In-flight
        searches keep their old store snapshot; the swap is one attribute
        assignment. Returns True when a newer generation was loaded.
        Owners return False (their store IS the source of truth), and an
        unreadable checkpoint keeps serving the current store."""
        if self.lock.held:
            return False
        try:
            meta = FingerprintStore.read_catalog_metadata(self.checkpoint_dir)
        except Exception:  # noqa: BLE001 - transient fault: keep serving
            log.warning("follow: checkpoint metadata unreadable; keeping "
                        "the current store")
            return False
        # _seen_gen, not _save_gen: after a .bak fallback the store's
        # save generation is deliberately 0, but the newest generation
        # OBSERVED at load time was recorded — without it every poll
        # would re-deserialize the same fallback checkpoint forever
        have = max(self.store._save_gen, self.store._seen_gen)
        if meta is None or int(meta.get("gen", 0)) <= have:
            return False
        try:
            store = FingerprintStore.load(
                self.checkpoint_dir, n_coefs=self.config.dsp.n_coefs,
                mesh=self.mesh,
            )
        except Exception:  # noqa: BLE001 - torn mid-rotation read etc.
            log.warning("follow: checkpoint reload failed; keeping the "
                        "current store", exc_info=True)
            return False
        for ctx in self.config.contexts:
            store.create_context(ctx.name, ctx.directory)
        self.store = store
        self.warm_search_maps()
        log.info(
            "follow: refreshed store from checkpoint (gen %d, %d audios)",
            store._restored_gen, len(store),
        )
        return True

    def reload(self, config: TiresiasConfig | None = None) -> SyncReport:
        """Live config reload — adopt a new config and re-sync.

        The reference declines reload outright (unload/load required,
        /root/reference/src/app_tiresias.c:608-614); here it is just a
        config swap + sync, since the store reconciles declaratively.
        DSP parameters are the exception: fingerprints already in the
        store were computed under the old chain, so changing them
        requires a fresh engine (raises ValueError)."""
        if config is not None:
            if config.dsp != self.config.dsp:
                raise ValueError(
                    "reload cannot change DSP parameters — stored "
                    "fingerprints were computed under the old chain; "
                    "rebuild with a fresh data_dir"
                )
            if config.expanded_data_dir != self.config.expanded_data_dir:
                # the restored store and checkpoint_dir are bound to the
                # old directory; silently keeping them while self.config
                # says otherwise would checkpoint to the wrong place
                raise ValueError(
                    "reload cannot change data_dir — the store is bound "
                    "to the old checkpoint directory; construct a new "
                    "Tiresias for a different data_dir"
                )
        old_config = self.config
        if config is not None:
            self.config = config
        try:
            return self.sync()
        except Exception:
            # a failed sync must not leave the NEW config active: later
            # watch ticks would silently keep reconciling under a config
            # the caller was told failed (contexts the new conf dropped
            # would be deleted). Partial sync work is self-healing — the
            # next tick under the restored config re-ingests from disk.
            self.config = old_config
            raise

    def warmup(
        self,
        samplerate: int = 8000,
        duration_ms: int = DEF_DURATION_MS,
        batch_sizes: tuple[int, ...] = (1,),
        laws: tuple[str, ...] = (),
    ) -> None:
        """Pre-compile the search graphs for the given window shapes so the
        first real request doesn't pay XLA compilation (the C reference is
        AOT-compiled; this is the JIT-world equivalent, backed by the
        persistent compilation cache).

        ``laws`` additionally warms G.711 wire-format graphs (uint8 +
        per-law device decode) — pass the formats the server advertises
        so the first trunk-byte window doesn't pay a compile."""
        n = int(samplerate * duration_ms / 1000)
        n -= n % self.config.dsp.hop_size
        n = max(n, self.config.dsp.hop_size)
        # jit keys on dtype: warm BOTH input dtypes the serve layer ships —
        # int16 (the TCP wire format, kept unconverted to the device) and
        # float32 (library callers) — or the first live window of the
        # other dtype pays a fresh XLA compile per batch bucket
        for silence in (
            np.zeros(n, dtype=np.int16),
            np.zeros(n, dtype=np.float32),
        ):
            for b in batch_sizes:
                with phase("engine.warmup"):
                    self.search_pcm_batch(None, [silence] * b, samplerate)
        for law in laws:
            from tiresias_tpu.utils.g711 import SILENCE_BYTE

            silence = np.full(n, SILENCE_BYTE[law], np.uint8)
            for b in batch_sizes:
                with phase("engine.warmup"):
                    self.search_pcm_batch(
                        None, [silence] * b, samplerate, wire_law=law
                    )
        self.warm_search_maps()

    def warmup_async(
        self,
        samplerate: int = 8000,
        duration_ms: int = DEF_DURATION_MS,
        batch_sizes: tuple[int, ...] = (1,),
        laws: tuple[str, ...] = (),
    ) -> "threading.Thread":
        """Readiness-tiered warmup.

        Compiles only the SERVING-CRITICAL programs synchronously — the
        int16 bucket programs (the TCP wire format) and the derived
        search maps — then compiles the rest (float32 buckets for
        library/file searches, G.711 per-law device-decode programs) on
        a daemon thread. Cold start to READY drops to roughly a third
        of the full bill.

        While a law's programs are still compiling, the streaming
        scorer host-expands that law's windows to int16 and uses the
        already-warm int16 programs — BIT-IDENTICAL results (the
        device's uint8 expansion table IS the int16 expansion divided
        by 32768, PARITY D18; :meth:`law_device_ready`). Returns the
        background thread (join it to wait for full warmth)."""
        n = int(samplerate * duration_ms / 1000)
        n -= n % self.config.dsp.hop_size
        n = max(n, self.config.dsp.hop_size)
        silence_i16 = np.zeros(n, dtype=np.int16)
        for b in batch_sizes:
            with phase("engine.warmup"):
                self.search_pcm_batch(None, [silence_i16] * b, samplerate)
        self.warm_search_maps()
        with self._warm_lock:
            for law in laws:
                self._laws_warming[law] = self._laws_warming.get(law, 0) + 1

        def _unpark(law):
            with self._warm_lock:
                left = self._laws_warming.get(law, 0) - 1
                if left <= 0:
                    self._laws_warming.pop(law, None)
                else:
                    self._laws_warming[law] = left

        def _background():
            pending = list(laws)  # this call's registrations still held
            try:
                silence_f32 = np.zeros(n, dtype=np.float32)
                for b in batch_sizes:
                    if self._warm_stop.is_set():
                        return
                    with phase("engine.warmup"):
                        self.search_pcm_batch(
                            None, [silence_f32] * b, samplerate
                        )
                from tiresias_tpu.utils.g711 import SILENCE_BYTE

                for law in laws:
                    silence = np.full(n, SILENCE_BYTE[law], np.uint8)
                    for b in batch_sizes:
                        if self._warm_stop.is_set():
                            return
                        with phase("engine.warmup"):
                            self.search_pcm_batch(
                                None, [silence] * b, samplerate,
                                wire_law=law,
                            )
                    _unpark(law)
                    pending.remove(law)
            finally:
                # a failed/aborted background warm must not leave a law
                # parked on the host-decode path forever — release only
                # THIS call's remaining registrations
                for law in pending:
                    _unpark(law)

        t = threading.Thread(
            target=_background, name="tiresias-warmup", daemon=True
        )
        with self._warm_lock:
            self._warm_threads = [
                x for x in self._warm_threads if x.is_alive()
            ]
            self._warm_threads.append(t)
        t.start()
        return t

    def law_device_ready(self, law: str) -> bool:
        """False while ``warmup_async`` is still compiling this G.711
        law's device-decode programs — callers (the streaming scorer)
        host-expand wire bytes to int16 in the meantime, which is
        bit-identical (PARITY D18). True in every other state: an
        un-warmed engine compiles on demand, as always."""
        with self._warm_lock:
            return law not in self._laws_warming

    def warm_search_maps(self) -> None:
        """Eagerly build the derived per-view device maps the dispatchable
        search paths consume lazily — the lattice value map (dialplan
        coefs=1 path) and, when the configured accuracy mode would route
        through the certified prefilter, its bound maps. A restored
        serving store otherwise pays the multi-second chunked build
        (100k-1M tracks) on the FIRST real request; after this, the maps
        are cached on the views and maintained incrementally across
        appends/deletes. No-op cost when already built."""
        from tiresias_tpu.ops.match_pallas import PREFILTER_K

        mc = self.config.match
        # the negative "use default" sentinel resolves at search time
        # (_resolve_search, fp_handler.c:252-256); warm with the value
        # real requests will actually run at, or the gates below would
        # skip maps the first live search then builds on demand
        tol = mc.tolerance if mc.tolerance >= 0 else DEF_SEARCH_TOLERANCE
        lattice_mode = mc.coefs == 1 and mc.trunc_coef1 and not mc.aligned
        for view in self.store.search_views():
            if view.n_audios == 0:
                continue
            # the device-rank tiebreak key is tiny next to the maps but
            # pays an H2D upload on first use — prebuild it too
            self.store.seq_for(view)
            if lattice_mode:
                # only the dialplan configuration routes through the
                # lattice value map — other modes must not pay its
                # multi-second build (or hold its HBM) for nothing
                self.store.value_map_for(view)
                if self._lattice_pf_ok(view, tol):
                    # the certified lattice prefilter's uint8 companion
                    # (one fused device pass over the f32 map); the
                    # runtime gate itself decides, so warmup can never
                    # build a map the dispatch will not use (e.g. on a
                    # mesh whose shard rows do not divide evenly)
                    self.store.value_map_q_for(view)
            if (
                mc.aligned
                and self.mesh is None
                and view.db.shape[0] > 2 * PREFILTER_K
                and not view.segments
            ):
                from tiresias_tpu.ops.match_lattice import bound_tol_ok

                if bound_tol_ok(mc.coefs, tol):
                    self.store.bound_maps_for(view, mc.coefs)

    def save(self) -> None:
        if not self.lock.held:
            from tiresias_tpu.utils.locking import DataDirLocked

            # fail loudly: a read-only engine checkpointing under a live
            # owner would race its generation rotation (two-writer hazard)
            raise DataDirLocked(
                self.config.expanded_data_dir, self.lock.owner_info()
            )
        self.store.save(self.checkpoint_dir)

    def close(self) -> None:
        """fp_term equivalent (/root/reference/src/fp_handler.c:92-108)."""
        # stop + drain any background warmup first: a daemon thread in
        # the middle of an XLA dispatch during interpreter teardown
        # aborts the process (observed as SIGABRT under SIGTERM)
        self._warm_stop.set()
        with self._warm_lock:
            threads = list(self._warm_threads)
        for t in threads:
            if t.is_alive():
                t.join(timeout=30)
        try:
            if self.lock.held:
                self.save()
        finally:
            self.lock.release()

    def __enter__(self) -> "Tiresias":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # context / audio CRUD (fp_handler.h:15-26)
    # ------------------------------------------------------------------ #

    def create_context(self, name: str, directory: str = "") -> None:
        self.store.create_context(name, directory)

    def delete_context(self, name: str) -> bool:
        return self.store.delete_context(name)

    def get_contexts(self) -> list[dict]:
        return self.store.get_contexts_all()

    def get_audios(self, context: str) -> list[AudioEntry]:
        return self.store.get_audios_by_context(context)

    def get_audio(self, uuid: str) -> AudioEntry | None:
        return self.store.get_audio(uuid)

    def delete_audio(self, uuid: str) -> bool:
        return self.store.delete_audio(uuid)

    def add_audio_file(self, context: str, path: str) -> SyncReport:
        """Fingerprint + store one file (fp_craete_audio_list_info [sic],
        /root/reference/src/fp_handler.h:25, fp_handler.c:161-197)."""
        return ingest_files(self.store, context, [path], self.config.dsp)

    def add_audio_pcm(
        self,
        context: str,
        name: str,
        pcm: np.ndarray,
        samplerate: int,
        file_hash: str | None = None,
        wire_law: str | None = None,
    ) -> AudioEntry | None:
        """Direct-PCM ingest (no temp files — the API the reference could not
        offer because aubio reads from disk). ``wire_law`` ingests raw
        G.711 trunk bytes (uint8) — e.g. recording a live channel straight
        into the store; the expansion is the same exact table the search
        paths use, so later wire queries of the same bytes self-match."""
        from tiresias_tpu.utils.audio import ensure_samplerate

        if wire_law is not None:
            from tiresias_tpu.utils.g711 import decode

            pcm = decode(pcm, wire_law)
        pcm, samplerate = ensure_samplerate(
            np.asarray(pcm), samplerate, self.config.dsp.samplerate
        )
        fp = fingerprint_signal(np.asarray(pcm), samplerate, self.config.dsp)
        if file_hash is None:
            import hashlib

            file_hash = hashlib.md5(
                np.ascontiguousarray(pcm, dtype=np.float32).tobytes()
            ).hexdigest()
        return self.store.add_audio(name, context, fp, file_hash)

    # compat alias preserving the reference's misspelled symbol (PARITY.md D6)
    fp_craete_audio_list_info = add_audio_file

    # ------------------------------------------------------------------ #
    # search (fp_search_fingerprint_info, /root/reference/src/fp_handler.c:207-408)
    # ------------------------------------------------------------------ #

    def search_pcm(
        self,
        context: str | None,
        pcm: np.ndarray,
        samplerate: int,
        coefs: int | None = None,
        tolerance: float | None = None,
        freq_ignore_low: int = -1,
        freq_ignore_high: int = -1,
        filter_context: bool = False,
        trunc_coef1: bool | None = None,
        aligned: bool | None = None,
        wire_law: str | None = None,
        min_margin: float | None = None,
    ) -> SearchResult:
        """Search one PCM signal; returns the TIR* result.

        Defaults mirror the dialplan app: ``coefs=1``
        (/root/reference/src/application_handler.c:180), tolerance from
        config ``[global]`` (:116-123). Like the reference, the scan covers
        ALL contexts unless ``filter_context=True`` (PARITY.md D7).
        ``trunc_coef1=False`` is the high-accuracy extension (PARITY.md D8).
        """
        res = self.search_pcm_batch(
            context,
            [np.asarray(pcm)],
            samplerate,
            coefs=coefs,
            tolerance=tolerance,
            freq_ignore_low=freq_ignore_low,
            freq_ignore_high=freq_ignore_high,
            filter_context=filter_context,
            trunc_coef1=trunc_coef1,
            aligned=aligned,
            wire_law=wire_law,
            min_margin=min_margin,
        )
        return res[0]

    def search_pcm_batch(
        self,
        context: str | None,
        pcms: list[np.ndarray],
        samplerate: int,
        coefs: int | None = None,
        tolerance: float | None = None,
        freq_ignore_low: int = -1,
        freq_ignore_high: int = -1,
        filter_context: bool = False,
        trunc_coef1: bool | None = None,
        aligned: bool | None = None,
        wire_law: str | None = None,
        min_margin: float | None = None,
    ) -> list[SearchResult]:
        """Batched search — many queries against the store in one device pass.

        ``wire_law`` ("ulaw"/"alaw") marks the batch as raw G.711 trunk
        bytes (uint8, one byte per 8 kHz sample): they ship to the device
        undecoded — half the int16 wire/H2D bytes — and expand on-chip via
        a 256-entry table gather, bit-identical to host decoding
        (ops/mfcc_jax.to_float_pcm; utils/g711.py).

        ``min_margin`` > 0 (config default MatchConfig.min_margin) gates
        acceptance on the winner's vote MARGIN over the runner-up audio:
        FOUND only when ``(v1 - v2) >= min_margin * v1``. The noise
        operating point (docs/performance.md §noise) — true matches win
        by a wide margin, impostors near-tie. Margin searches take the
        host-ranked path (the runner-up needs the full votes row)."""
        if not pcms:
            return []
        mm = (
            float(self.config.match.min_margin)
            if min_margin is None else float(min_margin)
        )
        if not 0.0 <= mm < 1.0:
            raise ValueError(f"min_margin must be in [0, 1), got {mm}")
        if mm > 0.0:
            fast = self._fused_strict_batch(
                context, pcms, samplerate, coefs, tolerance,
                freq_ignore_low, freq_ignore_high, filter_context,
                trunc_coef1, aligned, wire_law, min_margin=mm,
            )
            if fast is not None:
                return fast
            return self._margin_search_batch(
                context, pcms, samplerate, coefs, tolerance,
                freq_ignore_low, freq_ignore_high, filter_context,
                trunc_coef1, aligned, wire_law, mm,
            )
        fast = self._fused_search_batch(
            context, pcms, samplerate, coefs, tolerance,
            freq_ignore_low, freq_ignore_high, filter_context, trunc_coef1,
            aligned, wire_law,
        )
        if fast is not None:
            return fast
        fast = self._fused_strict_batch(
            context, pcms, samplerate, coefs, tolerance,
            freq_ignore_low, freq_ignore_high, filter_context, trunc_coef1,
            aligned, wire_law,
        )
        if fast is not None:
            return fast
        fast = self._device_ranked_batch(
            context, pcms, samplerate, coefs, tolerance,
            freq_ignore_low, freq_ignore_high, filter_context, trunc_coef1,
            aligned, wire_law,
        )
        if fast is not None:
            return fast
        votes_all, entries, n_frames = self._compute_votes(
            context, pcms, samplerate, coefs, tolerance,
            freq_ignore_low, freq_ignore_high, filter_context, trunc_coef1,
            aligned, wire_law=wire_law,
        )
        # top-1 with lowest-GLOBAL-insertion-index tiebreak (PARITY.md D5 —
        # stable across the tiered layout, matching the pre-tier behavior).
        # Vectorized: maximize votes then minimize rank == argmax of
        # votes*(A+1) - rank (scores are unique, so argmax == lexsort top).
        if votes_all.shape[1]:
            ins = self._insertion_order(entries)
            score = votes_all.astype(np.int64) * (len(ins) + 1) - ins[None, :]
            best = np.argmax(score, axis=1)
            count = votes_all[np.arange(len(pcms)), best]
            best = np.where(count > 0, best, -1)
        else:
            best = np.full(len(pcms), -1)
            count = np.zeros(len(pcms), np.int32)

        results: list[SearchResult] = []
        for i in range(len(pcms)):
            fc = int(n_frames[i])
            b = int(best[i])
            if b < 0 or b >= len(entries):
                results.append(SearchResult(STATUS_NOTFOUND, fc, 0))
                continue
            results.append(
                self._found(entries[b], fc, int(count[i]))
            )
        return results

    def search_pcm_topk(
        self,
        context: str | None,
        pcm: np.ndarray,
        samplerate: int,
        k: int = 5,
        coefs: int | None = None,
        tolerance: float | None = None,
        freq_ignore_low: int = -1,
        freq_ignore_high: int = -1,
        filter_context: bool = False,
        trunc_coef1: bool | None = None,
        aligned: bool | None = None,
        wire_law: str | None = None,
        min_margin: float | None = None,
    ) -> list[SearchResult]:
        """Ranked top-k candidates for one query (documented extension —
        the reference returns only the top-1 row, fp_handler.c:367-373).
        Only audios with at least one vote appear. ``min_margin`` does
        not apply — a ranked listing SHOWS the margins; rejecting it
        here keeps a gate-configured caller from silently assuming the
        table was filtered."""
        if min_margin:
            raise ValueError(
                "min_margin does not apply to ranked listings (the table "
                "shows every candidate; apply acceptance to the top-1 "
                "search instead)"
            )
        fast = self._device_ranked_topk(
            context, np.asarray(pcm), samplerate, k, coefs, tolerance,
            freq_ignore_low, freq_ignore_high, filter_context, trunc_coef1,
            aligned, wire_law,
        )
        if fast is not None:
            return fast
        votes_all, entries, n_frames = self._compute_votes(
            context, [np.asarray(pcm)], samplerate, coefs, tolerance,
            freq_ignore_low, freq_ignore_high, filter_context, trunc_coef1,
            aligned, prefilter=False, wire_law=wire_law,
        )
        fc = int(n_frames[0])
        votes = votes_all[0]
        if not votes.shape[0]:
            return []
        ins = self._insertion_order(entries)
        order = np.lexsort((ins, -votes))[:k]  # D5 insertion-order tiebreak
        return [
            self._found(entries[int(i)], fc, int(votes[i]))
            for i in order
            if votes[i] > 0
        ]

    def _aligned_prefiltered(
        self, view, qfp, n_frames, coefs, tolerance,
        freq_ignore_low, freq_ignore_high, trunc_coef1,
        ctx_id: int | None = None,
        top: int = 1,
        aligned: bool = True,
        defer_cert: bool = False,
    ):
        """Certified prefiltered aligned votes (device array) for one
        view, or None when any query's exactness certificate fails
        (→ caller full-scans). ``defer_cert=True`` skips the blocking
        certificate readback and returns ``(votes_d, cert_d)`` device
        arrays instead — the device-ranked path folds the certificate
        into its ONE combined readback (each blocking device_get is a
        host sync; deferral turns the staged strict path from ~3 syncs
        into ~1) and reports the outcome to _pf_note
        itself. ``ctx_id`` restricts candidate selection
        and certification to one context's rows (filter_context);
        ``top`` > 1 certifies an exact top-k listing instead of top-1.
        ``aligned=False`` rescores with the BAG matcher — the strict
        multi-coef config's fast path (the reference's own coefs=2
        library configuration, fp_handler.c:247-250; the same bound
        certifies it a fortiori — match_pallas docstring).
        On a meshed store the two-stage search runs PER DB SHARD under
        shard_map — every shard must certify or the view full-scans."""
        import jax

        from tiresias_tpu.ops.match_pallas import aligned_prefiltered_votes

        mode = "aligned" if aligned else "bag"
        if view.segments:
            # auto-split audios sum per-segment scores (D15); per-ROW
            # bounds can't certify the summed winner — full-scan instead
            return None
        q, active, use2 = match_jax.prepare_query(
            qfp, n_frames, freq_ignore_low, freq_ignore_high, trunc_coef1
        )
        specs, maps = self.store.bound_maps_for(view, coefs)
        ctx_ids = (
            self.store.ctx_ids_for(view) if ctx_id is not None else None
        )
        if self.mesh is not None:
            import jax.numpy as jnp

            from tiresias_tpu.parallel.sharding import (
                BATCH_AXIS,
                pad_to_multiple,
                sharded_aligned_prefiltered,
            )

            b = int(q.shape[0])
            n_batch = int(self.mesh.shape.get(BATCH_AXIS, 1))
            b_pad = pad_to_multiple(max(b, n_batch), n_batch)
            if b_pad != b:
                # zero-frame padding queries certify trivially
                pad = b_pad - b
                q = jnp.pad(q, ((0, pad), (0, 0), (0, 0)))
                active = jnp.pad(active, ((0, pad), (0, 0)))
                use2 = jnp.pad(use2, ((0, pad), (0, 0)))
            votes_d, certs_d = sharded_aligned_prefiltered(
                self.mesh, view.db, maps, q, active, use2, tolerance,
                specs, coefs, aligned=aligned,
                ctx_ids=ctx_ids, ctx_id=ctx_id, top=top,
            )
            if defer_cert:
                return votes_d[:b], certs_d
            certified = bool(jax.device_get(certs_d).all())
            self._pf_note(view, mode, certified)
            if not certified:
                return None
            return votes_d[:b]
        votes_d, cert_d = aligned_prefiltered_votes(
            view.db, maps, q, active, use2, tolerance, specs=specs,
            coefs=coefs, aligned=aligned, ctx_ids=ctx_ids, ctx_id=ctx_id,
            top=top,
        )
        if defer_cert:
            return votes_d, cert_d
        # only the [B] certificate crosses the link here; the [B, A] votes
        # stay on device (the device-ranked path reduces them there, the
        # host-ranked path reads them back itself)
        certified = bool(jax.device_get(cert_d).all())
        self._pf_note(view, mode, certified)
        return votes_d if certified else None

    def _lattice_pf_ok(self, view, tolerance, top: int = 1) -> bool:
        """Gate of the certified lattice prefilter (PARITY D19): size
        (selection must be real — per SHARD on a meshed store), tolerance
        (past uint8 saturation every row passes the bound — valid but
        never certifies), and an ADAPTIVE miss-streak cutoff: a corpus
        whose top-1 genuinely ties beyond k rows (1-coef bag voting at
        scale — the reference's own discrimination limit) de-certifies
        every query, and without the cutoff each one would pay the bound
        scan on top of the full-scan fallback (~1.25x). Eight consecutive
        failures disable the prefilter for the current view; any store
        mutation produces a new view object and re-arms it."""
        from tiresias_tpu.ops.match_lattice import (
            LATTICE_PREFILTER_K,
            bound_tol_ok,
        )

        a_rows = int(view.db.shape[0])
        if self.mesh is not None:
            n_db = int(self.mesh.shape.get("db", 1))
            if a_rows % n_db:
                return False  # shard rows must be exact (disjoint columns)
            a_rows //= n_db
        if (
            top > LATTICE_PREFILTER_K
            or a_rows <= 2 * LATTICE_PREFILTER_K
            or not bound_tol_ok(None, tolerance)
        ):
            return False
        return self._pf_allowed(view, "lattice")

    def _pf_allowed(self, view, mode: str) -> bool:
        """Adaptive miss-streak cutoff of the certified prefilters, keyed
        by the view's process-unique ``gen`` (per view AND per mode, so
        multi-tier stores and mixed lattice/aligned traffic each track
        their own streak) — 8 consecutive certificate misses disable the
        prefilter for that view; a certified result or a store mutation
        (new view, new gen) re-arms it."""
        with self._pf_lock:
            return self._pf_misses.get((view.gen, mode), 0) < 8

    def _pf_note(self, view, mode: str, certified: bool) -> None:
        """Feed a prefiltered search's certificate outcome back into the
        adaptive gate (every prefiltered path reports here). Serve-layer
        searches run on executor threads, so the dict is lock-guarded;
        a miss pops-and-reinserts its key, making insertion order
        least-recently-NOTED — the size bound then evicts stale view
        gens, never a live view's active streak."""
        key = (view.gen, mode)
        with self._pf_lock:
            if certified:
                self._pf_misses.pop(key, None)
            else:
                self._pf_misses[key] = self._pf_misses.pop(key, 0) + 1
                while len(self._pf_misses) > 32:  # stale gens age out
                    self._pf_misses.pop(next(iter(self._pf_misses)))
        if not certified:
            metrics.add("search.prefilter_fallbacks", 1)

    def _lattice_prefiltered(
        self, view, qfp, n_frames, tolerance,
        freq_ignore_low, freq_ignore_high,
        ctx_id: int | None = None,
        top: int = 1,
    ):
        """Certified prefiltered DIALPLAN votes (device array) for one
        view, or None when any query's exactness certificate fails
        (→ caller full-scans the f32 lattice map). The uint8-quantized
        map bounds every audio's vote count from above (floor-scaling
        only under-states distances), so rescoring the top-k candidates
        on the exact f32 map is provably identical to the full scan
        whenever the certificate holds — at a quarter of the map read
        traffic (ops.match_lattice.lattice_prefiltered_votes, PARITY D19).
        Unlike the aligned prefilter, auto-split views need no bailout:
        the lattice map min-combines segment rows into one exact
        per-audio row (follower rows hold the sentinel and never vote)."""
        import jax
        import jax.numpy as jnp

        from tiresias_tpu.ops.match_lattice import (
            lattice_prefiltered_votes,
        )

        vm = self.store.value_map_for(view)
        vm_q = self.store.value_map_q_for(view)
        b, f = qfp.shape[0], qfp.shape[1]
        valid = (
            jnp.ones((b, f), dtype=bool)
            if n_frames is None
            else jnp.arange(f)[None, :] < jnp.asarray(n_frames)[:, None]
        )
        lo, hi = match_jax.band_thresholds(
            freq_ignore_low, freq_ignore_high
        )
        ctx_ids = (
            self.store.ctx_ids_for(view) if ctx_id is not None else None
        )
        if self.mesh is not None:
            # per DB shard under shard_map: disjoint vote columns compose
            # exactly; every shard must certify or the view full-scans
            from tiresias_tpu.parallel.sharding import (
                BATCH_AXIS,
                pad_to_multiple,
                sharded_lattice_prefiltered,
            )

            q0 = qfp[..., 0]
            b = int(q0.shape[0])
            n_batch = int(self.mesh.shape.get(BATCH_AXIS, 1))
            b_pad = pad_to_multiple(max(b, n_batch), n_batch)
            if b_pad != b:
                # zero-frame padding queries certify trivially
                pad = b_pad - b
                q0 = jnp.pad(q0, ((0, pad), (0, 0)))
                valid = jnp.pad(valid, ((0, pad), (0, 0)))
            votes_d, certs_d = sharded_lattice_prefiltered(
                self.mesh, vm, vm_q, q0, valid, tolerance, lo, hi,
                ctx_ids=ctx_ids, ctx_id=ctx_id, top=top,
            )
            certified = bool(jax.device_get(certs_d).all())
            self._pf_note(view, "lattice", certified)
            return votes_d[:b] if certified else None
        votes_d, cert_d = lattice_prefiltered_votes(
            vm, vm_q, qfp[..., 0], valid, jnp.float32(tolerance),
            jnp.float32(lo), jnp.float32(hi), top=top,
            ctx_ids=ctx_ids, ctx_id=ctx_id,
        )
        # only the [B] certificate crosses the link; votes stay on device
        certified = bool(jax.device_get(cert_d).all())
        self._pf_note(view, "lattice", certified)
        return votes_d if certified else None

    @staticmethod
    def _merge_segment_votes(
        votes: np.ndarray, entries: list[AudioEntry]
    ) -> np.ndarray:
        """Fold an auto-split audio's per-segment vote columns into its
        first column (store.split_frames). On the lattice path segment
        columns are already zero (the distance map min-combines rows —
        exact semantics), making this a no-op; on the general matcher it
        sums per-segment votes (additive merge — PARITY.md D15). No-op for
        stores without over-long audios."""
        seen: dict[int, int] = {}
        dups = []
        for i, e in enumerate(entries):
            first = seen.setdefault(id(e), i)
            if first != i:
                dups.append((first, i))
        if not dups:
            return votes
        votes = votes.copy()
        for first, i in dups:
            votes[:, first] += votes[:, i]
            votes[:, i] = 0
        return votes

    @staticmethod
    def _insertion_order(entries: list[AudioEntry]) -> np.ndarray:
        """Dense global-insertion rank of a view-ordered snapshot (the D5
        tiebreak key). Derived from each entry's immutable insertion
        sequence number, so it stays aligned with THIS snapshot even if a
        concurrent sync deletes/adds entries between vote computation and
        ranking (a live store's positional ranks would not)."""
        seqs = np.fromiter(
            (e.seq for e in entries), dtype=np.int64, count=len(entries)
        )
        rank = np.empty(len(entries), dtype=np.int64)
        rank[np.argsort(seqs, kind="stable")] = np.arange(len(entries))
        return rank

    @staticmethod
    def _found(e: AudioEntry, frame_count: int, match_count: int) -> SearchResult:
        return SearchResult(
            status=STATUS_FOUND,
            frame_count=frame_count,
            match_count=match_count,
            uuid=e.uuid,
            name=e.name,
            context=e.context,
            hash=e.hash,
        )

    def _margin_search_batch(
        self, context, pcms, samplerate, coefs, tolerance,
        freq_ignore_low, freq_ignore_high, filter_context, trunc_coef1,
        aligned, wire_law, mm: float,
    ) -> list[SearchResult]:
        """Margin-gated acceptance (round 5, the noise operating point):
        host-ranked votes -> top-1 + runner-up AUDIO -> FOUND only when
        the margin fraction clears ``mm``. Exact (full scan or certified
        prefilter via _compute_votes)."""
        votes_all, entries, n_frames = self._compute_votes(
            context, [np.asarray(p) for p in pcms], samplerate, coefs,
            tolerance, freq_ignore_low, freq_ignore_high, filter_context,
            trunc_coef1, aligned, wire_law=wire_law,
            prefilter_top=2,  # the runner-up must be certified too
        )
        results: list[SearchResult] = []
        if not votes_all.shape[1]:
            return [
                SearchResult(STATUS_NOTFOUND, int(n_frames[i]), 0)
                for i in range(len(pcms))
            ]
        ins = self._insertion_order(entries)
        score = votes_all.astype(np.int64) * (len(ins) + 1) - ins[None, :]
        best = np.argmax(score, axis=1)
        for i in range(len(pcms)):
            fc = int(n_frames[i])
            b = int(best[i])
            v1 = int(votes_all[i, b])
            if v1 <= 0:
                results.append(SearchResult(STATUS_NOTFOUND, fc, 0))
                continue
            row = votes_all[i].copy()
            row[b] = -1
            v2 = max(int(row.max()), 0)
            if (v1 - v2) < mm * v1:
                # runner-up too close: ambiguous at this tolerance
                results.append(SearchResult(STATUS_NOTFOUND, fc, 0))
                continue
            results.append(self._found(entries[b], fc, v1))
        return results

    def _fused_search_batch(
        self,
        context: str | None,
        pcms: list[np.ndarray],
        samplerate: int,
        coefs: int | None,
        tolerance: float | None,
        freq_ignore_low: int,
        freq_ignore_high: int,
        filter_context: bool,
        trunc_coef1: bool | None,
        aligned: bool | None,
        wire_law: str | None = None,
    ) -> list[SearchResult] | None:
        """Single-dispatch fast path for the dialplan configuration
        (coefs=1, truncation, bag-of-frames) against a single-tier store.
        Returns None when the staged path must run instead."""
        (coefs, tolerance, lo, hi, trunc_coef1, aligned) = \
            self._resolve_search(coefs, tolerance, freq_ignore_low,
                                 freq_ignore_high, trunc_coef1, aligned)
        if coefs != 1 or not trunc_coef1 or aligned:
            return None
        ctx_id = self._ctx_filter_id(context, filter_context)
        views = self.store.search_views()
        if len(views) != 1:
            return None  # multi-tier: global tiebreak spans views
        import jax.numpy as jnp

        view = views[0]
        pcms, samplerate, wire_law = self._resample_queries(
            [np.asarray(p) for p in pcms], samplerate, wire_law
        )
        from tiresias_tpu.ops.mfcc_jax import pad_frames_bucket

        with phase("search.match"):
            padded, n_frames = pad_frames_bucket(
                pcms, self.config.dsp.hop_size, law=wire_law
            )
            n_valid = (
                jnp.asarray([len(p) for p in pcms], jnp.int32)
                if wire_law is not None else None
            )
            band_lo, band_hi = match_jax.band_thresholds(lo, hi)
            from tiresias_tpu.ops.match_lattice import LATTICE_PREFILTER_K

            # single-device only here: the fused jit is not shard-mapped,
            # and meshed stores take the staged sharded prefilter instead
            use_prefilter = self.mesh is None and self._lattice_pf_ok(
                view, tolerance
            )
            run = _fused_lattice_fn(
                self.config.dsp, samplerate, wire_law,
                prefilter=use_prefilter,
                k=LATTICE_PREFILTER_K if use_prefilter else 0,
            )
            vm_args = (self.store.value_map_for(view),)
            if use_prefilter:
                vm_args += (self.store.value_map_q_for(view),)
            out = run(
                padded, jnp.asarray(n_frames),
                *vm_args,
                jnp.float32(tolerance), jnp.float32(band_lo),
                jnp.float32(band_hi),
                None if ctx_id is None else self.store.ctx_ids_for(view),
                ctx_id,
                n_valid=n_valid,
            )
            import jax

            # one transfer for all outputs — a second readback would be
            # another blocking host sync
            got = jax.device_get(out)
            best, count = got[0], got[1]
            if use_prefilter:
                # the lax.cond already served the exact full scan on a
                # failed certificate; the note only feeds the adaptive
                # gate so a never-certifying corpus stops paying the
                # bound scan
                self._pf_note(view, "lattice", bool(got[2]))
        metrics.add("search.queries", len(pcms))
        results: list[SearchResult] = []
        for i in range(len(pcms)):
            fc = int(n_frames[i])
            b = int(best[i])
            if b < 0 or b >= view.n_audios:
                results.append(SearchResult(STATUS_NOTFOUND, fc, 0))
            else:
                results.append(
                    self._found(view.entries[b], fc, int(count[i]))
                )
        return results

    def _fused_strict_batch(
        self,
        context: str | None,
        pcms: list[np.ndarray],
        samplerate: int,
        coefs: int | None,
        tolerance: float | None,
        freq_ignore_low: int,
        freq_ignore_high: int,
        filter_context: bool,
        trunc_coef1: bool | None,
        aligned: bool | None,
        wire_law: str | None = None,
        min_margin: float = 0.0,
    ) -> list[SearchResult] | None:
        """Single-dispatch fast path for the STRICT (no-truncation)
        multicoef configurations — bag (the reference's own coefs=2
        library config, fp_handler.c:247-250) and aligned (the
        recommended accuracy mode) — against a single-tier store:
        :func:`_fused_strict_fn`'s fused prefilter + top-1. Returns None
        when the staged path must run instead (multi-tier, mesh,
        tolerances past the value-encoded masking bound)."""
        (coefs, tolerance, lo, hi, trunc_coef1, aligned) = \
            self._resolve_search(coefs, tolerance, freq_ignore_low,
                                 freq_ignore_high, trunc_coef1, aligned)
        if trunc_coef1:
            return None  # truncation configs take the lattice paths
        if self.mesh is not None:
            return None
        views = self.store.search_views()
        if len(views) != 1 or views[0].segments:
            return None
        view = views[0]
        from tiresias_tpu.ops.match_lattice import bound_tol_ok
        from tiresias_tpu.ops.match_pallas import PALLAS_TOL_MAX, PREFILTER_K

        mode = "aligned" if aligned else "bag"
        a_rows = int(view.db.shape[0])
        if tolerance >= PALLAS_TOL_MAX:
            return None  # value-encoded kernels need tol < sentinel gap
        # prefilter only when the bound stage can pay off; otherwise the
        # ONE-dispatch program still runs, just without the bound stage
        # (small stores, saturating tolerances, or an adaptively-gated
        # never-certifying corpus — its in-dispatch full scan still saves
        # the staged path's extra dispatches and readbacks)
        use_pf = (
            a_rows > 2 * PREFILTER_K
            and bound_tol_ok(coefs, tolerance)
            and self._pf_allowed(view, mode)
        )
        ctx_id = self._ctx_filter_id(context, filter_context)
        import jax
        import jax.numpy as jnp

        pcms, samplerate, wire_law = self._resample_queries(
            [np.asarray(p) for p in pcms], samplerate, wire_law
        )
        from tiresias_tpu.ops.mfcc_jax import pad_frames_bucket

        with phase("search.match"):
            padded, n_frames = pad_frames_bucket(
                pcms, self.config.dsp.hop_size, law=wire_law
            )
            n_valid = (
                jnp.asarray([len(p) for p in pcms], jnp.int32)
                if wire_law is not None else None
            )
            ci = None if ctx_id is None else self.store.ctx_ids_for(view)
            top2 = min_margin > 0.0  # margin needs the runner-up audio
            count2 = None
            if use_pf:
                specs, maps = self.store.bound_maps_for(view, coefs)
                run = _fused_strict_fn(
                    self.config.dsp, samplerate, wire_law, coefs, aligned,
                    PREFILTER_K, lo, hi, specs, top2=top2,
                )
                out = run(
                    padded, jnp.asarray(n_frames), view.db, maps,
                    jnp.float32(tolerance), ci, ctx_id, n_valid=n_valid,
                )
                # one transfer for all outputs (best, count[, runner-up],
                # certificate)
                got = jax.device_get(out)
                best, count = got[0], got[1]
                if top2:
                    count2 = got[2]
                certified = bool(got[-1])
                self._pf_note(view, mode, certified)
            else:
                run = _fused_strict_fn(
                    self.config.dsp, samplerate, wire_law, coefs, aligned,
                    0, lo, hi, (), prefilter=False, top2=top2,
                )
                out = run(
                    padded, jnp.asarray(n_frames), view.db,
                    jnp.float32(tolerance), ci, ctx_id, n_valid=n_valid,
                )
                got = jax.device_get(out)
                best, count = got[0], got[1]
                if top2:
                    count2 = got[2]
        metrics.add("search.queries", len(pcms))
        results: list[SearchResult] = []
        for i in range(len(pcms)):
            fc = int(n_frames[i])
            b = int(best[i])
            if b < 0 or b >= view.n_audios:
                results.append(SearchResult(STATUS_NOTFOUND, fc, 0))
                continue
            v1 = int(count[i])
            if count2 is not None and (
                v1 - int(count2[i])
            ) < min_margin * v1:
                # margin acceptance: runner-up too close (the runner-up
                # votes are exact — top-2 certificate or full scan)
                results.append(SearchResult(STATUS_NOTFOUND, fc, 0))
                continue
            results.append(self._found(view.entries[b], fc, v1))
        return results

    def _ctx_filter_id(
        self, context: str | None, filter_context: bool
    ) -> int | None:
        """The device keep key for a filtered search, or None for the
        reference's scan-everything behavior (context=None keeps D7 even
        when filtering is requested). ONE definition so the fused, staged,
        and device-ranked paths can never diverge on the filter rule."""
        if not filter_context or context is None:
            return None
        return self.store.ctx_id_for(context)

    def _resolve_search(
        self,
        coefs: int | None,
        tolerance: float | None,
        freq_ignore_low: int,
        freq_ignore_high: int,
        trunc_coef1: bool | None,
        aligned: bool | None,
    ) -> tuple[int, float, int, int, bool, bool]:
        """Apply the config-default / clamp rules shared by every search
        entry point (fp_handler.c:247-256; -1 band args = unspecified)."""
        mc: MatchConfig = self.config.match
        if aligned is None:
            aligned = mc.aligned
        if coefs is None:
            coefs = mc.coefs
        if tolerance is None:
            tolerance = mc.tolerance
        if trunc_coef1 is None:
            trunc_coef1 = mc.trunc_coef1
        # -1 means "unspecified" for the band-ignore args (the dialplan
        # omit-value, application_handler.c:126-137); fall back to the
        # [global] config defaults, mirroring the tolerance handling.
        if freq_ignore_low < 0:
            freq_ignore_low = mc.freq_ignore_low
        if freq_ignore_high < 0:
            freq_ignore_high = mc.freq_ignore_high
        if tolerance < 0:
            tolerance = DEF_SEARCH_TOLERANCE  # fp_handler.c:252-256
        if coefs < 1 or coefs > self.config.dsp.n_coefs:
            raise ValueError(
                f"coefs must be in [1, {self.config.dsp.n_coefs}] "
                "(fp_handler.c:247-250)"
            )
        return (coefs, float(tolerance), freq_ignore_low, freq_ignore_high,
                bool(trunc_coef1), bool(aligned))

    def _resample_queries(
        self, pcms: list[np.ndarray], samplerate: int,
        law: str | None = None,
    ) -> tuple[list[np.ndarray], int, str | None]:
        """Force the configured analysis rate when set (DspConfig.samplerate
        > 0; 0 = native rate, fp_handler.c:37,612).

        G.711 wire batches (``law``) that need resampling are expanded on
        host first — companded bytes can't be filtered — and continue as
        linear PCM (law=None)."""
        target = self.config.dsp.samplerate
        if target > 0 and int(samplerate) != target:
            from tiresias_tpu.utils.audio import ensure_samplerate

            if law is not None:
                from tiresias_tpu.utils.g711 import decode

                pcms = [decode(p, law) for p in pcms]
                law = None
            pcms = [ensure_samplerate(p, samplerate, target)[0] for p in pcms]
            samplerate = target
        return pcms, int(samplerate), law

    def _compute_votes(
        self,
        context: str | None,
        pcms: list[np.ndarray],
        samplerate: int,
        coefs: int | None,
        tolerance: float | None,
        freq_ignore_low: int,
        freq_ignore_high: int,
        filter_context: bool,
        trunc_coef1: bool | None,
        aligned: bool | None = None,
        prefilter: bool = True,
        wire_law: str | None = None,
        prefilter_top: int = 1,
    ) -> tuple[np.ndarray, list[AudioEntry], np.ndarray]:
        """(votes [B, A], view-ordered entries, n_frames [B]).

        ``prefilter=False`` disables the certified two-stage aligned path
        (top-k listings need every audio's true score, not just the
        certified winner's); ``prefilter_top`` widens the certificate to
        an exact top-N (the margin path needs a certified RUNNER-UP —
        a candidate-only second-best would understate v2 and over-accept)."""
        (coefs, tolerance, freq_ignore_low, freq_ignore_high, trunc_coef1,
         aligned) = self._resolve_search(
            coefs, tolerance, freq_ignore_low, freq_ignore_high,
            trunc_coef1, aligned,
        )
        pcms, samplerate, wire_law = self._resample_queries(
            pcms, samplerate, wire_law
        )
        # context-filtered searches keep the certified prefilter: the
        # context's rows are selected ON DEVICE (store.ctx_ids_for keep
        # key), so the certificate certifies the IN-context winner and the
        # accuracy mode keeps its fast path under the opt-in filter too
        ctx_id = self._ctx_filter_id(context, filter_context)
        with phase("search.fingerprint"):
            # async: qfp stays on device; the matcher dispatches chain on it
            # without a host round trip (padding frames hold real silence
            # values — every matcher masks by n_frames, so they never vote)
            qfp, n_frames = fingerprint_signals_async(
                pcms, samplerate, self.config.dsp, law=wire_law
            )
        with phase("search.match"):
            # one matcher pass per frame tier; votes concatenate exactly
            # (audios are whole within a tier — store docstring)
            views = self.store.search_views()
            entries: list[AudioEntry] = []
            vote_parts: list[np.ndarray] = []
            use_lattice = coefs == 1 and trunc_coef1 and not aligned
            for view in views:
                votes = self._votes_for_view(
                    view, qfp, n_frames, coefs, tolerance,
                    freq_ignore_low, freq_ignore_high, trunc_coef1,
                    aligned, prefilter, use_lattice,
                    ctx_id=ctx_id, prefilter_top=prefilter_top,
                )
                vote_parts.append(np.asarray(votes)[:, : view.n_audios])
                entries.extend(view.entries)

            votes_all = (
                np.concatenate(vote_parts, axis=1)
                if vote_parts
                else np.zeros((len(pcms), 0), np.int32)
            )
            votes_all = self._merge_segment_votes(votes_all, entries)
            if filter_context and context is not None:
                # context=None keeps the reference's scan-everything
                # behavior (PARITY.md D7) even when filtering is requested
                keep = np.array(
                    [e.context == context for e in entries], dtype=bool
                )
                votes_all = np.where(keep[None, :], votes_all, 0)
        metrics.add("search.queries", len(pcms))
        return votes_all, entries, np.asarray(n_frames)

    def _votes_for_view(
        self, view, qfp, n_frames, coefs, tolerance,
        freq_ignore_low, freq_ignore_high, trunc_coef1, aligned,
        prefilter, use_lattice,
        ctx_id: int | None = None,
        prefilter_top: int = 1,
        certs_out: list | None = None,
    ):
        """Device votes ``[B, A_pad]`` for one view — the kernel-dispatch
        rules shared by the staged host-ranked path (:meth:`_compute_votes`)
        and the device-ranked path (:meth:`_device_ranked_batch`).

        ``certs_out``: when given, a prefiltered view's exactness
        certificate is NOT read back here — ``(view, mode, cert_d)`` is
        appended and the votes are returned unchecked; the caller must
        fold the cert arrays into its own single readback, report each
        via _pf_note, and re-run with ``prefilter=False`` if any failed
        (saves one blocking readback per search).

        with_top1=False everywhere: the engine ranks with the D5
        insertion tiebreak itself, so the wrappers' device argmax+gather
        over [B, A] would be dispatched and discarded on every search."""
        from tiresias_tpu.ops.match_pallas import PALLAS_TOL_MAX

        # the fused matchers (Triton kernels on the GPU) need the
        # value-encoded masking bound; past it the masked XLA matcher runs
        fused = tolerance < PALLAS_TOL_MAX
        if use_lattice:
            # dialplan configuration → exact lattice fast path
            from tiresias_tpu.ops.match_lattice import search_lattice

            votes = None
            if prefilter and self._lattice_pf_ok(
                view, tolerance, prefilter_top
            ):
                # certified two-stage dialplan search: uint8 bound scan →
                # exact f32 rescore of the top-K candidates; provably
                # identical to the full scan when the certificate holds,
                # full scan otherwise (PARITY D19)
                votes = self._lattice_prefiltered(
                    view, qfp, n_frames, tolerance,
                    freq_ignore_low, freq_ignore_high,
                    ctx_id=ctx_id, top=prefilter_top,
                )
            if votes is None:
                _, _, votes = search_lattice(
                    self.store.value_map_for(view),
                    qfp,
                    n_frames,
                    tolerance=tolerance,
                    freq_ignore_low=freq_ignore_low,
                    freq_ignore_high=freq_ignore_high,
                    with_top1=False,
                )
        elif fused and self.mesh is None:
            # generic semantics, fused matcher (bag-of-frames or
            # offset-consistent aligned votes)
            from tiresias_tpu.ops.match_pallas import (
                PREFILTER_K,
                search_batch_pallas,
            )

            from tiresias_tpu.ops.match_lattice import bound_tol_ok

            votes = None
            if (
                prefilter
                and view.db.shape[0] > 2 * PREFILTER_K
                and prefilter_top <= PREFILTER_K
                # past uint8 saturation the bound maps stop informing:
                # the certificate can never hold, so skip the pipeline
                and bound_tol_ok(coefs, tolerance)
                and self._pf_allowed(
                    view, "aligned" if aligned else "bag"
                )
            ):
                # certified two-stage search: lattice bound (shared
                # with the dialplan path's distance map) → exact
                # rescore of the top-K candidates with the requested
                # matcher — aligned (accuracy mode) or bag (the strict
                # multi-coef config); provably identical
                # to the full scan when the certificate holds, full
                # scan otherwise
                votes = self._aligned_prefiltered(
                    view, qfp, n_frames, coefs, tolerance,
                    freq_ignore_low, freq_ignore_high, trunc_coef1,
                    ctx_id=ctx_id, top=prefilter_top, aligned=aligned,
                    defer_cert=certs_out is not None,
                )
                if certs_out is not None and votes is not None:
                    votes, cert_d = votes
                    certs_out.append(
                        (view, "aligned" if aligned else "bag", cert_d)
                    )
            if votes is None:
                _, _, votes = search_batch_pallas(
                    view.db,
                    qfp,
                    n_frames,
                    coefs=coefs,
                    tolerance=tolerance,
                    freq_ignore_low=freq_ignore_low,
                    freq_ignore_high=freq_ignore_high,
                    trunc_coef1=trunc_coef1,
                    aligned=aligned,
                    with_top1=False,
                )
        elif fused:
            # sharded store: fused matcher per DB shard under
            # shard_map (bag or aligned), vote columns disjoint —
            # same result as the GSPMD XLA matcher
            from tiresias_tpu.ops.match_pallas import PREFILTER_K
            from tiresias_tpu.parallel.sharding import sharded_search

            from tiresias_tpu.ops.match_lattice import bound_tol_ok

            votes = None
            n_db = int(self.mesh.shape.get("db", 1))
            if (
                prefilter
                and prefilter_top <= PREFILTER_K
                and view.db.shape[0] % n_db == 0
                and view.db.shape[0] // n_db > 2 * PREFILTER_K
                and bound_tol_ok(coefs, tolerance)
                and self._pf_allowed(
                    view, "aligned" if aligned else "bag"
                )
            ):
                # certified two-stage search (aligned or strict-bag),
                # per DB shard (the same gates as the single-device
                # path, per shard)
                votes = self._aligned_prefiltered(
                    view, qfp, n_frames, coefs, tolerance,
                    freq_ignore_low, freq_ignore_high, trunc_coef1,
                    ctx_id=ctx_id, top=prefilter_top, aligned=aligned,
                    defer_cert=certs_out is not None,
                )
                if certs_out is not None and votes is not None:
                    votes, cert_d = votes
                    certs_out.append(
                        (view, "aligned" if aligned else "bag", cert_d)
                    )
            if votes is not None:
                return votes
            _, _, votes = sharded_search(
                self.mesh,
                view.db,
                view.mask,
                qfp,
                n_frames,
                coefs=coefs,
                tolerance=tolerance,
                freq_ignore_low=freq_ignore_low,
                freq_ignore_high=freq_ignore_high,
                trunc_coef1=trunc_coef1,
                aligned=aligned,
                use_pallas=True,
                with_top1=False,
            )
        else:
            _, _, votes = match_jax.search_batch(
                view.db,
                view.mask,
                qfp,
                n_frames,
                coefs=coefs,
                tolerance=tolerance,
                freq_ignore_low=freq_ignore_low,
                freq_ignore_high=freq_ignore_high,
                trunc_coef1=trunc_coef1,
                aligned=aligned,
                with_top1=False,
            )
        return votes

    def _device_rank_setup(
        self, context, pcms, samplerate, coefs, tolerance,
        freq_ignore_low, freq_ignore_high, filter_context, trunc_coef1,
        aligned, wire_law=None,
    ) -> dict | None:
        """Shared front half of BOTH device-ranked paths (top-1 and
        top-k): resolve parameters, check the fallback conditions, and
        fingerprint. One definition so the eligibility rules cannot
        diverge between the two. Returns None when the search needs full
        votes on host: auto-split audios (per-segment vote sums, D15).
        Context-filtered searches stay on-device: the per-view ctx-id
        arrays zero out-of-context votes inside the scoring dispatch."""
        (coefs, tolerance, freq_ignore_low, freq_ignore_high, trunc_coef1,
         aligned) = self._resolve_search(
            coefs, tolerance, freq_ignore_low, freq_ignore_high,
            trunc_coef1, aligned,
        )
        ctx_id = self._ctx_filter_id(context, filter_context)
        views = self.store.search_views()
        if not views or any(v.segments for v in views):
            return None
        pcms, samplerate, wire_law = self._resample_queries(
            [np.asarray(p) for p in pcms], samplerate, wire_law
        )
        with phase("search.fingerprint"):
            qfp, n_frames = fingerprint_signals_async(
                pcms, samplerate, self.config.dsp, law=wire_law
            )
        return {
            "views": views,
            "qfp": qfp,
            "n_frames": n_frames,
            "n": len(pcms),
            "vote_args": (
                coefs, tolerance, freq_ignore_low, freq_ignore_high,
                trunc_coef1, aligned,
            ),
            "use_lattice": coefs == 1 and trunc_coef1 and not aligned,
            "ctx_id": ctx_id,
        }

    def _device_ranked_batch(
        self,
        context: str | None,
        pcms: list[np.ndarray],
        samplerate: int,
        coefs: int | None,
        tolerance: float | None,
        freq_ignore_low: int,
        freq_ignore_high: int,
        filter_context: bool,
        trunc_coef1: bool | None,
        aligned: bool | None,
        wire_law: str | None = None,
    ) -> list[SearchResult] | None:
        """Top-1 computed ON DEVICE for the staged multi-matcher path.

        The host-ranked path reads the full ``[B, A]`` votes matrix back
        per search (4 MB/query at 1M tracks) just to argmax it; here each
        view reduces to three ``[B]`` vectors on device — score (votes
        lexically combined with the D5 insertion key), winning votes, and
        winning row — and only those cross the link. Returns None when
        _device_rank_setup says the search needs full votes on host."""
        setup = self._device_rank_setup(
            context, pcms, samplerate, coefs, tolerance, freq_ignore_low,
            freq_ignore_high, filter_context, trunc_coef1, aligned,
            wire_law,
        )
        if setup is None:
            return None
        views, qfp, n_frames = setup["views"], setup["qfp"], setup["n_frames"]
        use_lattice = setup["use_lattice"]
        ctx_id = setup["ctx_id"]

        def rank_one(view, prefilter: bool, certs_out):
            votes = self._votes_for_view(
                view, qfp, n_frames, *setup["vote_args"],
                prefilter, use_lattice,
                ctx_id=ctx_id, certs_out=certs_out,
            )
            return _top1_scored(
                votes, self.store.seq_for(view),
                None if ctx_id is None
                else self.store.ctx_ids_for(view),
                ctx_id,
            )

        import jax

        with phase("search.match"):
            # deferred certificates: the prefiltered views' cert arrays
            # ride the SAME readback as the top-1 reductions — each extra
            # blocking device_get is another host sync
            certs_out: list = []
            per_view = [rank_one(v, True, certs_out) for v in views]
            got, certs_got = jax.device_get(
                (per_view, [c for _, _, c in certs_out])
            )
            failed = set()
            for (view, mode, _), cval in zip(certs_out, certs_got):
                certified = bool(np.all(cval))
                self._pf_note(view, mode, certified)
                if not certified:
                    failed.add(id(view))
            if failed:
                # rare (certificate refused — near-duplicate corpus):
                # ONLY the refusing views' prefiltered votes are
                # inexact; full-scan those and keep every other view's
                # already-exact reduction (certified prefilters and
                # non-prefiltered views alike)
                redo = [
                    (i, v) for i, v in enumerate(views)
                    if id(v) in failed
                ]
                redone = jax.device_get(
                    [rank_one(v, False, None) for _, v in redo]
                )
                for (i, _), r in zip(redo, redone):
                    got[i] = r
        metrics.add("search.queries", setup["n"])
        n_frames = np.asarray(n_frames)
        # cross-view lexicographic combine in host int64: maximize votes,
        # tie → lowest seq. Seqs are globally unique, so the argmax picks
        # the exact D5 winner deterministically.
        votes_v = np.stack([g[0] for g in got]).astype(np.int64)  # [V, B]
        seqs_v = np.stack([g[1] for g in got]).astype(np.int64)
        win = np.argmax(votes_v * (1 << 32) - seqs_v, axis=0)
        results: list[SearchResult] = []
        for i in range(len(pcms)):
            v = int(win[i])
            count = int(got[v][0][i])
            fc = int(n_frames[i])
            if count <= 0:
                results.append(SearchResult(STATUS_NOTFOUND, fc, 0))
                continue
            results.append(
                self._found(views[v].entries[int(got[v][2][i])], fc, count)
            )
        return results

    def _device_ranked_topk(
        self,
        context: str | None,
        pcm: np.ndarray,
        samplerate: int,
        k: int,
        coefs: int | None,
        tolerance: float | None,
        freq_ignore_low: int,
        freq_ignore_high: int,
        filter_context: bool,
        trunc_coef1: bool | None,
        aligned: bool | None,
        wire_law: str | None = None,
    ) -> list[SearchResult] | None:
        """Top-k computed ON DEVICE: each view reduces to three [1, k]
        arrays (lax.top_k values + gathered insertion seqs + rows) — the
        k·V-candidate merge happens on host, never the [1, A] votes row
        (see _device_ranked_batch for the fallback conditions). Within a
        view, top_k's lower-index tiebreak IS per-tier insertion order,
        so each view's candidates are its exact lexicographic top-k and
        the union is a superset of the global top-k."""
        setup = self._device_rank_setup(
            context, [pcm], samplerate, coefs, tolerance, freq_ignore_low,
            freq_ignore_high, filter_context, trunc_coef1, aligned,
            wire_law,
        )
        if setup is None:
            return None
        views, qfp, n_frames = setup["views"], setup["qfp"], setup["n_frames"]
        use_lattice = setup["use_lattice"]
        per_view = []
        with phase("search.match"):
            ctx_id = setup["ctx_id"]
            for view in views:
                kk = min(int(k), int(view.db.shape[0]))
                # prefilter_top: the certified top-k prefilter puts every
                # audio reaching the view's k-th best score inside the
                # candidate set with its EXACT score, so the listing below
                # equals the full scan's; certificate failure (or an
                # out-of-gate shape) falls back to the full scan here.
                # Bucketed to the next power of two: top is a STATIC jit
                # arg, and per-distinct-N recompiles would stall a serving
                # store (a LARGER top is a strictly STRICTER certificate,
                # so exactness is preserved — at worst it fails more often
                # and full-scans)
                from tiresias_tpu.ops.match_pallas import PREFILTER_K
                from tiresias_tpu.utils import next_pow2

                # an over-budget kk passes through un-bucketed so the
                # prefilter gate (prefilter_top <= PREFILTER_K) rejects it
                # — a bucketed value could sneak a too-small listing in
                ptop = next_pow2(kk) if kk <= PREFILTER_K else kk
                votes = self._votes_for_view(
                    view, qfp, n_frames, *setup["vote_args"],
                    True, use_lattice,
                    ctx_id=ctx_id, prefilter_top=ptop,
                )
                per_view.append(
                    _topk_scored_fn(kk)(
                        votes, self.store.seq_for(view),
                        None if ctx_id is None
                        else self.store.ctx_ids_for(view),
                        ctx_id,
                    )
                )
            import jax

            got = jax.device_get(per_view)
        metrics.add("search.queries", 1)
        fc = int(np.asarray(n_frames)[0])
        cands = []  # (-votes, seq, view, row): sort() IS the D5 order
        for v, (tv, ts, ti) in enumerate(got):
            for j in range(tv.shape[1]):
                votes_j = int(tv[0, j])
                if votes_j <= 0:
                    continue
                cands.append((-votes_j, int(ts[0, j]), v, int(ti[0, j])))
        cands.sort()
        return [
            self._found(views[v].entries[row], fc, -negv)
            for negv, _seq, v, row in cands[: int(k)]
        ]

    def search_file(
        self,
        context: str | None,
        path: str,
        coefs: int | None = None,
        tolerance: float | None = None,
        freq_ignore_low: int = -1,
        freq_ignore_high: int = -1,
        filter_context: bool = False,
        trunc_coef1: bool | None = None,
        aligned: bool | None = None,
        min_margin: float | None = None,
    ) -> SearchResult:
        """fp_search_fingerprint_info over a file on disk
        (/root/reference/src/fp_handler.h:27-34)."""
        pcm, samplerate = read_audio(path)
        return self.search_pcm(
            context,
            pcm,
            samplerate,
            coefs=coefs,
            tolerance=tolerance,
            freq_ignore_low=freq_ignore_low,
            freq_ignore_high=freq_ignore_high,
            filter_context=filter_context,
            trunc_coef1=trunc_coef1,
            aligned=aligned,
            min_margin=min_margin,
        )

    # ------------------------------------------------------------------ #
    # hashing helpers (fp_generate_hash / fp_generate_uuid, fp_handler.h:36-38)
    # ------------------------------------------------------------------ #

    @staticmethod
    def generate_hash(path: str) -> str:
        return file_md5(path)

    @staticmethod
    def generate_uuid() -> str:
        from tiresias_tpu.utils.hashing import generate_uuid

        return generate_uuid()
