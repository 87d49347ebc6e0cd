"""Catalog ↔ config ↔ filesystem synchronisation and batched ingest.

Device-batched rebuild of the reference's init-time reconciliation
(/root/reference/src/app_tiresias.c:230-358 ``init_context``/``init_audio``,
:365-424 ``create_new_audio_info``, :431-551 ``delete_removed_audio_info``):

  * contexts present in the store but absent from config are deleted with all
    their audios (:250-276); contexts in config are created (:279-315).
  * per context: audios whose file MD5 is no longer present on disk are
    deleted (:431-551); new files are fingerprinted and added with MD5 dedupe
    (:365-424 → /root/reference/src/fp_handler.c:479-575).

The per-file serial aubio loop + one-SQL-INSERT-per-frame of the reference
(SURVEY.md hot loops A/B) becomes a three-stage pipeline: host threads
decode/hash files while full device batches are dispatched asynchronously
(:func:`tiresias_tpu.ops.mfcc_jax.fingerprint_signals_async`); the readback
and store write of batch *k* happen while batch *k+1* executes on device
and later files are still decoding — producer/consumer overlap, not a
host-pass-then-device-pass barrier.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tiresias_tpu.config import DspConfig, TiresiasConfig
from tiresias_tpu.ops.mfcc_jax import (
    fingerprint_signals_async,
    mask_fingerprints,
)
from tiresias_tpu.store.fingerprint_store import FingerprintStore
from tiresias_tpu.utils import next_pow2
from tiresias_tpu.utils.audio import ensure_samplerate, read_audio, read_wav_i16
from tiresias_tpu.utils.hashing import file_md5
from tiresias_tpu.utils.logging import get_logger
from tiresias_tpu.utils.tracing import phase

log = get_logger(__name__)

# Max signals fingerprinted per device batch: fewer, larger dispatches for
# the same bytes.
INGEST_BATCH = 512
# Frame bucket for ingest batches. Finer than the search-side 128 bucket:
# ingest is H2D-bandwidth-bound, and a 3 s telephony clip (94 frames) padded
# to 128 would ship 36% padding; at 32 it ships 2%. More distinct compile
# shapes, but each compiles once and persists in the compilation cache.
INGEST_FRAME_MULTIPLE = 32
# Peak padded samples per device batch (batches pad every signal to the
# longest member): 64 clips x 30 s @ 8 kHz. Packing by this cap — with
# signals sorted by length so similar lengths share a batch — bounds host
# and HBM memory even when a directory mixes hour-long files with clips.
MAX_BATCH_PADDED_SAMPLES = 64 * 30 * 8000
# Host decode/hash pool width (I/O + GIL-releasing work).
HOST_DECODE_THREADS = 8


def batch_exceeds(count: int, longest: int) -> bool:
    """Would a batch of ``count`` signals padded to ``longest`` samples
    exceed either ingest bound (signal count, padding-inclusive samples —
    batch cost = count x longest member)? The single source of truth for
    the pipelined batcher in :func:`ingest_files`."""
    return count > INGEST_BATCH or count * longest > MAX_BATCH_PADDED_SAMPLES


@dataclasses.dataclass
class SyncReport:
    created: int = 0
    deduped: int = 0
    deleted: int = 0
    failed: int = 0

    def __iadd__(self, other: "SyncReport") -> "SyncReport":
        self.created += other.created
        self.deduped += other.deduped
        self.deleted += other.deleted
        self.failed += other.failed
        return self


def scan_directory(directory: str) -> list[str] | None:
    """Sorted file names, skipping only ``.``/``..`` like the reference's
    ``file_select`` (/root/reference/src/app_tiresias.c:553-572).

    Returns None (not []) when the directory itself is unreadable — callers
    must distinguish "empty" from "unavailable": treating a transient mount
    failure as an empty directory would delete every audio in the context.
    """
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        log.error("could not scan directory %s", directory)
        return None
    return [n for n in names if os.path.isfile(os.path.join(directory, n))]


def hash_directory(directory: str) -> dict[str, str] | None:
    """{path: md5} for every readable file (thread-pooled); None when the
    directory is unreadable (see scan_directory)."""
    names = scan_directory(directory)
    if names is None:
        return None
    paths = [os.path.join(directory, n) for n in names]
    out: dict[str, str] = {}
    with ThreadPoolExecutor(max_workers=HOST_DECODE_THREADS) as pool:
        for path, future in [(p, pool.submit(file_md5, p)) for p in paths]:
            try:
                out[path] = future.result()
            except OSError:
                continue
    return out


def delete_removed_audio(
    store: FingerprintStore,
    context: str,
    directory: str,
    disk_hashes: set[str] | None = None,
) -> int:
    """Delete store entries whose MD5 no longer matches any file on disk
    (delete_removed_audio_info, /root/reference/src/app_tiresias.c:431-551).

    An unreadable directory deletes NOTHING — a transient I/O failure must
    not destroy the context's fingerprints."""
    if disk_hashes is None:
        hashes = hash_directory(directory)
        if hashes is None:
            return 0
        disk_hashes = set(hashes.values())
    stale = [
        entry
        for entry in store.get_audios_by_context(context)
        if entry.hash not in disk_hashes
    ]
    deleted = store.delete_audios(e.uuid for e in stale)
    for entry in stale:
        log.info("deleted stale audio %s (%s)", entry.name, entry.uuid)
    return deleted


def _batch_bucket(n: int, cap: int = INGEST_BATCH) -> int:
    """Round a batch size up to a power of two (capped) so XLA compiles at
    most log2(cap) batch shapes per frame bucket instead of one per count."""
    return next_pow2(n, cap)


def ingest_files(
    store: FingerprintStore,
    context: str,
    paths: list[str],
    dsp: DspConfig | None = None,
    known_hashes: dict[str, str] | None = None,
    mesh=None,
) -> SyncReport:
    """Fingerprint new files in device batches and add them to the store.

    Dedupe is by (context, file MD5) exactly like create_audio_list_info
    (/root/reference/src/fp_handler.c:494-507). Files that fail to decode are
    skipped with a log, mirroring the reference's per-file continue
    (/root/reference/src/app_tiresias.c:415-419).

    Pipelined: decode/hash runs on a thread pool; as soon as a device batch
    fills, it is dispatched asynchronously, and its readback + store write
    happen while the NEXT batch executes and later files decode. Paths are
    submitted in file-size order so arrivals are roughly length-ordered and
    batch padding stays tight (batch cost = count x longest member).

    ``mesh``: optional single-controller ``jax.sharding.Mesh`` — batches
    are then fingerprinted data-parallel over EVERY device (batch axis
    sharded, ``parallel.sharding.sharded_fingerprint``), the multi-chip
    scale-out of the reference's one-file-at-a-time ingest loop
    (/root/reference/src/fp_handler.c:604-652).
    """
    dsp = dsp or DspConfig()
    report = SyncReport()

    def load_one(path: str):
        digest = (known_hashes or {}).get(path) or file_md5(path)
        law = None
        decoded = read_wav_i16(path)
        # 16-bit mono PCM ships to device as raw int16 (half the bytes,
        # bit-identical after the device-side /32768); G.711 telephony
        # WAVs ship as their RAW companded bytes (ONE byte per sample —
        # quarter of float's wire traffic; the on-chip table expansion
        # is bit-identical to host decoding, PARITY D18); anything else
        # — float/multichannel WAV or compressed formats — via read_audio
        if decoded is not None:
            pcm, samplerate = decoded
        else:
            from tiresias_tpu.utils.audio import read_wav_g711

            g711 = read_wav_g711(path)
            if g711 is not None:
                pcm, samplerate, law = g711
            else:
                pcm, samplerate = read_audio(path)
        # a positive DspConfig.samplerate forces one analysis rate
        # (reference: 0 = native rate, fp_handler.c:37,612); companded
        # bytes can't be filtered, so a G.711 file that needs resampling
        # expands on host first and continues as linear PCM
        if (
            law is not None
            and dsp.samplerate > 0
            and int(samplerate) != int(dsp.samplerate)
        ):
            from tiresias_tpu.utils.g711 import decode as g711_decode

            pcm, law = g711_decode(pcm, law), None
        pcm, samplerate = ensure_samplerate(pcm, samplerate, dsp.samplerate)
        return path, digest, pcm, samplerate, law

    def drain(inflight) -> None:
        """Read back a dispatched batch and write it into the store."""
        items, fp_dev, n_frames = inflight
        fps = mask_fingerprints(np.asarray(fp_dev), n_frames)
        for i, (path, digest, _) in enumerate(items):
            entry = store.add_audio(
                name=os.path.basename(path),
                context=context,
                fingerprint=fps[i, : int(n_frames[i])],
                file_hash=digest,
            )
            if entry is None:
                report.deduped += 1
            else:
                report.created += 1
                log.info("ingested %s as %s", path, entry.uuid)

    inflight = None  # at most one dispatched-but-undrained batch

    def dispatch(samplerate: int, law: str | None, items: list) -> None:
        nonlocal inflight
        pcms = [pcm for _, _, pcm in items]
        # pad the batch count to a power-of-two bucket with empty signals
        # (sliced off in drain via items' length) — bounded compile shapes
        target = _batch_bucket(len(pcms))
        if mesh is not None:  # batch must split evenly over the mesh
            n_dev = int(mesh.devices.size)
            target = -(-target // n_dev) * n_dev
        pcms += [np.zeros(0, pcms[0].dtype)] * (target - len(pcms))
        with phase("ingest.fingerprint_batch"):
            if mesh is not None:
                from tiresias_tpu.ops.mfcc_jax import pad_frames_bucket
                from tiresias_tpu.parallel.sharding import (
                    sharded_fingerprint,
                )

                padded, n_frames = pad_frames_bucket(
                    pcms, dsp.hop_size, INGEST_FRAME_MULTIPLE, law=law
                )
                n_valid = (
                    np.array([len(p) for p in pcms], np.int32)
                    if law is not None else None
                )
                fp_dev = sharded_fingerprint(
                    mesh, padded, samplerate, dsp, law=law, n_valid=n_valid
                )
            else:
                fp_dev, n_frames = fingerprint_signals_async(
                    pcms, samplerate, dsp,
                    bucket_multiple=INGEST_FRAME_MULTIPLE, law=law,
                )
        prev, inflight = inflight, (items, fp_dev, n_frames)
        if prev is not None:
            drain(prev)

    # decode in size order (≈ length order for PCM) on the pool; consume in
    # the same order so batches pack near-uniform lengths
    def size_of(p: str) -> int:
        try:
            return os.path.getsize(p)
        except OSError:
            return 0

    # batches are uniform in (samplerate, wire format): the fingerprint
    # dispatch decodes a whole batch with one law
    buckets: dict[
        tuple[int, str | None], list[tuple[str, str, np.ndarray]]
    ] = {}
    seen_hashes: set[tuple[str, str]] = set()
    # bounded decode window: submit at most ~2x the thread count and
    # replace each consumed future with the next path. Eager submission
    # would keep EVERY decoded pcm alive (a consumed Future still
    # references its result while the list holds it) — on a large corpus
    # the host RSS would grow to the whole decoded corpus while the
    # device drains at link speed.
    path_iter = iter(sorted(paths, key=size_of))
    with ThreadPoolExecutor(max_workers=HOST_DECODE_THREADS) as pool:
        from collections import deque
        from itertools import islice

        pending = deque(
            pool.submit(load_one, p)
            for p in islice(path_iter, 2 * HOST_DECODE_THREADS)
        )
        while pending:
            future = pending.popleft()
            nxt = next(path_iter, None)
            if nxt is not None:
                pending.append(pool.submit(load_one, nxt))
            try:
                path, digest, pcm, samplerate, law = future.result()
            except Exception:  # noqa: BLE001 - any unreadable file is skipped
                report.failed += 1
                continue
            del future  # the Future would otherwise pin the pcm result
            if (context, digest) in seen_hashes or store.find_by_hash(
                context, digest
            ):
                report.deduped += 1
                continue
            if len(pcm) == 0:
                log.warning("empty audio %s", path)
                report.failed += 1
                continue
            if pcm.dtype not in (np.int16, np.uint8) and not np.isfinite(
                pcm
            ).all():
                # NaN/Inf samples (possible in float32 WAVs) would collapse
                # to floor-valued fingerprints that spuriously match silence
                log.warning("non-finite samples in %s", path)
                report.failed += 1
                continue
            seen_hashes.add((context, digest))
            key = (int(samplerate), law)
            items = buckets.setdefault(key, [])
            if items and batch_exceeds(
                len(items) + 1,
                max(len(pcm), *(len(it[2]) for it in items)),
            ):
                dispatch(key[0], key[1], items)
                items = buckets[key] = []
            items.append((path, digest, pcm))
    for (samplerate, law), items in buckets.items():
        if items:
            dispatch(samplerate, law, items)
    if inflight is not None:
        drain(inflight)
    return report


def sync_context_audio(
    store: FingerprintStore,
    context: str,
    directory: str,
    dsp: DspConfig | None = None,
    mesh=None,
) -> SyncReport:
    """delete-removed + create-new for one context
    (init_audio per-context body, /root/reference/src/app_tiresias.c:324-358)."""
    report = SyncReport()
    if not store.get_audios_by_context(context):
        # COLD context: nothing can be deleted, so the separate MD5
        # directory pass is pure overhead — let the ingest pipeline hash
        # each file on the decode pool instead (one read per file, not
        # two; ~12% of a link-bound 1k-clip cold sync)
        names = scan_directory(directory)
        if names is None:
            # unreadable directory: sync is a no-op, never a mass delete
            return report
        paths = [os.path.join(directory, n) for n in names]
        report += ingest_files(store, context, paths, dsp, None, mesh=mesh)
        return report
    hashes = hash_directory(directory)  # one MD5 pass serves both phases
    if hashes is None:
        # unreadable directory: sync is a no-op, never a mass delete
        return report
    report.deleted = delete_removed_audio(
        store, context, directory, set(hashes.values())
    )
    report += ingest_files(store, context, list(hashes), dsp, hashes,
                           mesh=mesh)
    return report


def sync_contexts(store: FingerprintStore, config: TiresiasConfig) -> None:
    """Reconcile the store's contexts with config
    (init_context, /root/reference/src/app_tiresias.c:230-321)."""
    configured = {c.name: c.directory for c in config.contexts}
    for ctx in store.get_contexts_all():
        if ctx["name"] not in configured:
            store.delete_context(ctx["name"])
            log.info("deleted context %s (absent from config)", ctx["name"])
    for name, directory in configured.items():
        store.create_context(name, directory)


def sync_all(
    store: FingerprintStore,
    config: TiresiasConfig,
    checkpoint_dir: str | None = None,
    mesh=None,
) -> SyncReport:
    """Full init-time sync: contexts, then per-context audio, checkpointing
    after each context's ingest (crash-safe improvement, PARITY.md D2)."""
    sync_contexts(store, config)
    total = SyncReport()
    for ctx in config.contexts:
        with phase("sync.context"):
            report = sync_context_audio(store, ctx.name, ctx.directory,
                                        config.dsp, mesh=mesh)
        total += report
        if checkpoint_dir and (report.created or report.deleted):
            store.save(checkpoint_dir)
    return total
