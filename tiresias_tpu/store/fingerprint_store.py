"""HBM-resident fingerprint store + host-side catalog.

Device-resident replacement for the reference's storage layer — the in-memory
SQLite database (``":memory:"``, /root/reference/src/fp_handler.c:30) holding
``context_list`` / ``audio_list`` / ``audio_fingerprint`` tables
(/root/reference/src/fp_handler.c:673-756) behind the db_ctx abstraction
(/root/reference/src/db_ctx_handler.c). Per-frame SQL rows become dense
matrices; the catalog (uuid/name/context/md5) stays on host as plain Python.

Layout — **frame-capacity tiers**: each audio lives whole in the tier whose
frame capacity (128·2^k) fits it, so one hour-long file among 3-second clips
costs only its own tier instead of inflating every row (the dense-matrix
trade-off a single matrix would have; the reference's per-frame rows had no
waste at the price of per-row scan cost). Within a tier:

  * ``matrix`` — float32 ``[capacity, tier_frames, n_coefs]``, one row per
    audio, ``PAD_VALUE`` beyond each audio's ``n_frames`` (no tolerance band
    can ever match padding).
  * ``entries`` — insertion-ordered list; list index == matrix row.

Searches run per tier and concatenate votes — audios are disjoint across
tiers, so per-tier vote counts are exactly the reference's per-audio counts
(no audio is ever split). The flat catalog (``self.entries``) keeps global
insertion order for listings; search-result attribution uses the per-tier
view order (tiers ascending, insertion order within — the documented
deterministic tie-break, PARITY.md D5).

Capacities grow geometrically and device views are padded to fixed buckets
so ``jit`` recompiles stay bounded as the store grows.

Checkpointing replaces the SQLite online-backup/restore pair
(/root/reference/src/db_ctx_handler.c:673-717, 750-772): an atomic
write-to-tmp + rename of ``catalog.json`` + ``fingerprints.npz`` (one array
per tier), previous generation kept as ``*.bak``. Unlike the reference —
which persists only at clean unload, losing everything on a crash
(/root/reference/src/fp_handler.c:97-103) — callers checkpoint after each
ingest batch (PARITY.md D2).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
import threading
from typing import Iterable

import numpy as np

from tiresias_tpu.config import DEF_N_COEFS
from tiresias_tpu.ops.mfcc_jax import PAD_VALUE
from tiresias_tpu.utils.hashing import generate_uuid
from tiresias_tpu.utils.logging import get_logger

log = get_logger(__name__)

CHECKPOINT_VERSION = 4
CATALOG_FILE = "catalog.json"
MATRIX_FILE = "fingerprints.npz"  # v1/v2 checkpoints (still loadable)
# v3 layout: immutable per-tier SEGMENT files (tier<t>_seg<i>.g<gen>.npy),
# committed by the catalog rename; only segments touched since the last
# save are rewritten, so per-ingest checkpoints cost O(batch), not O(DB).
# v4 = v3 plus an optional per-tier "dead" row list (tombstoned deletes are
# persisted without rewriting segments; dead rows are dropped at load).
SEGMENT_ROWS = 2048

# Device-view padding buckets: audio axis to multiples of 128 (one Pallas
# match tile); frame tiers are 128·2^k.
AUDIO_BUCKET = 128
FRAME_BUCKET = 128
MAX_TIER_FRAMES = FRAME_BUCKET * 2**14  # ~2.1M frames ≈ 18.6 h at 8 kHz


def tier_for(n_frames: int) -> int:
    """Smallest tier frame-capacity that fits ``n_frames``."""
    if n_frames > MAX_TIER_FRAMES:
        raise ValueError(
            f"audio of {n_frames} frames exceeds the maximum tier "
            f"({MAX_TIER_FRAMES}); split the file before ingest"
        )
    t = FRAME_BUCKET
    while t < n_frames:
        t *= 2
    return t


def split_frames(n_frames: int) -> list[int]:
    """Per-segment frame counts for one audio: ``[n_frames]`` when it fits
    a tier; otherwise MAX_TIER_FRAMES-sized chunks plus the tail.

    The reference fingerprints unbounded-length files (its serial loop just
    runs until the source ends, /root/reference/src/fp_handler.c:632-661);
    dense tiers cap a row at ~18.6 h, so longer audios are auto-split into
    segment ROWS that share one catalog entry. Votes merge per audio: the
    lattice (dialplan) path merges EXACTLY — segment distance-map rows are
    min-combined into the first row, which is precisely the reference's
    ∃t-over-the-whole-audio semantics; the general matcher path sums
    per-segment votes (additive — a query frame matching in two segments
    counts twice; documented deviation, PARITY.md D15)."""
    if n_frames <= MAX_TIER_FRAMES:
        return [n_frames]
    out = []
    rem = n_frames
    while rem > 0:
        out.append(min(rem, MAX_TIER_FRAMES))
        rem -= MAX_TIER_FRAMES
    return out


@dataclasses.dataclass
class AudioEntry:
    """One ``audio_list`` row (/root/reference/src/fp_handler.c:700-706)."""

    uuid: str
    name: str
    context: str
    hash: str
    n_frames: int
    # monotonic per-store insertion sequence (assigned by _restore_entry;
    # not persisted — the catalog's entry order encodes it). Immutable once
    # assigned, so a snapshot's D5 tiebreak stays correct even if the store
    # mutates concurrently.
    seq: int = dataclasses.field(default=-1, compare=False)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("seq")
        return d

    @staticmethod
    def from_dict(d: dict) -> "AudioEntry":
        return AudioEntry(
            uuid=d["uuid"],
            name=d["name"],
            context=d["context"],
            hash=d["hash"],
            n_frames=int(d["n_frames"]),
        )


class CheckpointIncompatible(ValueError):
    """A checkpoint that is structurally valid but cannot be loaded into
    this store (version or n_coefs mismatch) — fails loudly instead of
    silently falling back a generation."""


class CheckpointUnreadable(RuntimeError):
    """Checkpoint generations exist in the directory but NONE could be
    read. Failing loudly here is load-bearing: silently returning an empty
    store would let the next save rotate the catalogs and GC every segment
    file — a transient read error (EIO, NFS blip, torn copy) would become
    permanent data loss."""


def _fsync_dir(directory: str) -> None:
    """fsync a directory so a completed rename survives power loss (the
    file-data fsyncs happen before the rename; this persists the name).
    Filesystems that don't support directory fsync (some FUSE/overlay/
    network mounts return EINVAL/ENOTSUP/EBADF) are tolerated: the rename
    already succeeded, we just lose the power-loss guarantee there."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _readable_catalog(path: str) -> bool:
    """Whether a catalog generation parses — the rotation guard: a corrupt
    current catalog must never be rotated over a good ``.bak``."""
    try:
        with open(path) as f:
            json.load(f)
        return True
    except Exception:  # noqa: BLE001 - any unreadable generation
        return False


def _read_catalog_gen(path: str) -> int:
    """A catalog generation's ``gen`` field, 0 when unreadable/absent."""
    try:
        with open(path) as f:
            return int(json.load(f).get("gen", 0))
    except Exception:  # noqa: BLE001 - any unreadable generation
        return 0


def _put_replicated(arr, mesh):
    """A host array as a device array, REPLICATED on ``mesh`` (or plain
    when mesh is None). The one placement rule every mesh-aware helper
    here shares: in multi-controller mode a process-local ``jnp.asarray``
    mixed with a global sharded array is rejected, so replicated operands
    must be placed via ``put_global``."""
    import jax.numpy as jnp

    if mesh is None:
        return jnp.asarray(arr)
    from jax.sharding import PartitionSpec

    from tiresias_tpu.parallel.distributed import put_global

    return put_global(np.asarray(arr), mesh, PartitionSpec())


def _bucket(n: int, multiple: int) -> int:
    return max(multiple, -(-n // multiple) * multiple)


_SEG_GEN_RE = re.compile(r"^tier\d+_seg\d+\.g(\d+)\.npy$")


_update_rows_jit = None
_update_rows_sharded: dict = {}  # (mesh, ndim) -> sharded update executable


def _update_rows(buf, rows, index: int, mesh=None):
    """``buf[index:index+len(rows)] = rows`` as a NEW device array: only
    ``rows`` crosses host→device; the rest is an on-device HBM copy (~1 ms
    per GB — vs seconds to re-upload through a host link). Deliberately
    not donated: a concurrent search may still hold the previous view, and
    donation would invalidate its buffers mid-flight. The start index is
    traced, so one executable serves every offset.

    On a mesh, ``rows`` must already be a global (replicated) array and the
    output is pinned back to the view's row sharding (``P('db', ...)``) —
    without ``out_shardings`` GSPMD may gather the updated buffer, silently
    un-sharding the DB after the first live append."""
    global _update_rows_jit
    import jax

    if mesh is None:
        if _update_rows_jit is None:
            def upd(b, r, i):
                start = (i,) + (0,) * (b.ndim - 1)
                return jax.lax.dynamic_update_slice(b, r.astype(b.dtype), start)

            _update_rows_jit = jax.jit(upd)
        return _update_rows_jit(buf, rows, index)

    from jax.sharding import NamedSharding, PartitionSpec

    key = (mesh, buf.ndim)
    fn = _update_rows_sharded.get(key)
    if fn is None:
        spec = PartitionSpec("db", *([None] * (buf.ndim - 1)))

        def upd(b, r, i):
            start = (i,) + (0,) * (b.ndim - 1)
            return jax.lax.dynamic_update_slice(b, r.astype(b.dtype), start)

        fn = jax.jit(upd, out_shardings=NamedSharding(mesh, spec))
        _update_rows_sharded[key] = fn
    return fn(buf, rows, index)


def _combine_segment_rows(vm, groups, mesh=None):
    """Min-combine an auto-split audio's lattice-map rows into its FIRST
    row (the others become +inf). min over segment rows == min over the
    whole audio's frames — EXACTLY the reference's one-vote-per-audio
    ∃t test (GROUP BY, fp_handler.c:353) across the full unbounded length.
    Groups are rare (only >18.6 h audios), so a small python loop of
    at-set updates is fine. On a (possibly multi-host) mesh the index
    arrays must be GLOBAL — a process-local jnp.asarray mixed with the
    global sharded map is rejected in multi-controller mode (same
    constraint as _extend_view.to_dev)."""
    if not groups:
        return vm
    import jax.numpy as jnp

    for g in groups:
        rows = _put_replicated(np.asarray(list(g), np.int32), mesh)
        combined = jnp.min(vm[rows], axis=0)
        vm = vm.at[g[0]].set(combined)
        if len(g) > 1:
            vm = vm.at[rows[1:]].set(jnp.inf)
    return vm


_scatter_rows_fns: dict = {}  # (mesh, ndim, dtype) -> executable


def _scatter_rows(buf, idx: np.ndarray, fill, mesh=None):
    """``buf[idx] = fill`` (scalar) as a NEW device array — the tombstone
    device update: only the k row indices cross host→device; the buffer is
    copied on device with the rows overwritten. idx is padded to a
    power-of-two bucket (repeats are harmless for a constant fill) so
    compile shapes stay bounded. Not donated: a concurrent search may hold
    the previous view. On a mesh the output is pinned back to the view's
    ``P('db', ...)`` sharding (see _update_rows), and the index array is
    placed as a GLOBAL replicated array — a process-local jnp.asarray
    mixed with the global buffer is rejected in multi-controller mode.
    The fill is baked into the executable as a static constant (there are
    only a handful of fill values: False / PAD_VALUE / +inf), so no scalar
    array ever crosses as an operand."""
    import jax

    from tiresias_tpu.utils import next_pow2

    k_pad = next_pow2(len(idx))
    idx_p = np.full(k_pad, idx[0], np.int32)
    idx_p[: len(idx)] = idx
    fill_const = float(fill)
    key = (mesh, buf.ndim, str(buf.dtype), fill_const)
    fn = _scatter_rows_fns.get(key)
    if fn is None:
        def upd(b, i):
            return b.at[i].set(jax.numpy.asarray(fill_const, b.dtype))

        if mesh is None:
            fn = jax.jit(upd)
        else:
            from jax.sharding import NamedSharding, PartitionSpec

            spec = PartitionSpec("db", *([None] * (buf.ndim - 1)))
            fn = jax.jit(upd, out_shardings=NamedSharding(mesh, spec))
        _scatter_rows_fns[key] = fn
    return fn(buf, _put_replicated(idx_p, mesh))


def _max_seg_gen(directory: str) -> int:
    """Highest generation number among segment files in a directory."""
    best = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    for name in names:
        m = _SEG_GEN_RE.match(name)
        if m:
            best = max(best, int(m.group(1)))
    return best


class _Tier:
    """One frame-capacity tier: dense matrix + row-ordered entries."""

    def __init__(self, tier_frames: int, n_coefs: int) -> None:
        self.t = tier_frames
        self.n_coefs = n_coefs
        self.matrix = np.full((0, tier_frames, n_coefs), PAD_VALUE, np.float32)
        # One list slot per matrix ROW. An over-long audio (auto-split, see
        # split_frames) occupies several consecutive rows that all point at
        # the SAME AudioEntry; row_frames holds each row's own frame count
        # (== entry.n_frames except for segments).
        self.entries: list[AudioEntry] = []
        self.row_frames: list[int] = []
        self.rows: dict[str, int] = {}  # uuid -> FIRST matrix row
        self.uuid_rows: dict[str, list[int]] = {}  # multi-row audios only
        # Tombstoned rows: deletes DO NOT move matrix rows — the row is
        # marked dead and masked off the device view in O(deleted rows)
        # device work (a compaction would force a full view re-upload, a
        # ~20 s stall per delete on a 1M-track serving store). Dead rows are
        # reclaimed by :meth:`compact` once they exceed the waste threshold.
        self.dead: set[int] = set()
        self.view_dead_pending: set[int] = set()  # dead since last view
        # first row whose content changed since the last checkpoint save
        # (rows only ever change from some index to the end: appends at the
        # end; compaction shifts everything after the first hole)
        self.dirty_from = 0
        # same tracking relative to the last device-view build: appends keep
        # this == the old row count (incremental view update); compaction
        # drops it below (full view rebuild)
        self.view_clean_from = 0

    @property
    def n_live(self) -> int:
        return len(self.entries) - len(self.dead)

    def ensure_capacity(self, n_rows: int) -> None:
        cap = self.matrix.shape[0]
        new_cap = cap
        while new_cap < n_rows:
            new_cap = max(AUDIO_BUCKET, new_cap * 2)
        if new_cap != cap:
            grown = np.full(
                (new_cap, self.t, self.n_coefs), PAD_VALUE, np.float32
            )
            grown[:cap] = self.matrix
            self.matrix = grown

    def _add_row(self, entry: AudioEntry, chunk: np.ndarray) -> int:
        row = len(self.entries)
        self.ensure_capacity(row + 1)
        self.matrix[row] = PAD_VALUE
        self.matrix[row, : chunk.shape[0]] = chunk
        self.entries.append(entry)
        self.row_frames.append(int(chunk.shape[0]))
        self.dirty_from = min(self.dirty_from, row)
        self.view_clean_from = min(self.view_clean_from, row)
        return row

    def add(self, entry: AudioEntry, fingerprint: np.ndarray) -> None:
        self.rows[entry.uuid] = self._add_row(entry, fingerprint)

    def add_segmented(
        self, entry: AudioEntry, fingerprint: np.ndarray, segs: list[int]
    ) -> None:
        """One over-long audio as consecutive segment rows (split_frames).
        Always called under the store lock, so segments never straddle a
        device-view build."""
        rows = []
        off = 0
        for n in segs:
            rows.append(self._add_row(entry, fingerprint[off : off + n]))
            off += n
        self.rows[entry.uuid] = rows[0]
        self.uuid_rows[entry.uuid] = rows

    def row_of(self, uuid: str) -> int | None:
        return self.rows.get(uuid)

    def delete(self, uuid: str) -> AudioEntry | None:
        """Tombstone an audio's row(s): O(1) host work, matrix untouched.
        The device view masks the rows off incrementally (search_views)."""
        first = self.rows.pop(uuid, None)
        if first is None:
            return None
        e = self.entries[first]
        for i in self.uuid_rows.pop(uuid, [first]):
            self.dead.add(i)
            self.view_dead_pending.add(i)
        return e

    def delete_many(self, uuids) -> list[AudioEntry]:
        """Tombstone every audio whose uuid is in ``uuids``. Returns the
        removed entries in (first-)row order."""
        doomed = sorted((r, u) for u, r in self.rows.items() if u in uuids)
        removed = []
        for first, u in doomed:
            removed.append(self.entries[first])
            self.rows.pop(u, None)
            for i in self.uuid_rows.pop(u, [first]):
                self.dead.add(i)
                self.view_dead_pending.add(i)
        return removed

    def should_compact(self) -> bool:
        """Reclaim tombstones once they are both numerous (several view
        rows' worth) and a large fraction of the tier — bounds wasted host
        RAM/HBM at ~25% while keeping steady-state deletes O(1)."""
        return (
            len(self.dead) >= AUDIO_BUCKET
            and 4 * len(self.dead) >= len(self.entries)
        )

    def compact(self) -> None:
        """Physically remove tombstoned rows (one memmove pass). The next
        :meth:`FingerprintStore.search_views` does a full view rebuild."""
        if not self.dead:
            return
        doomed = sorted(self.dead)
        n = len(self.entries)
        keep = np.ones(n, bool)
        keep[doomed] = False
        keep_idx = np.flatnonzero(keep)
        remap = {int(old): new for new, old in enumerate(keep_idx)}
        self.matrix[: len(keep_idx)] = self.matrix[keep_idx]
        self.matrix[len(keep_idx) : n] = PAD_VALUE
        self.entries = [self.entries[i] for i in keep_idx]
        self.row_frames = [self.row_frames[i] for i in keep_idx]
        # rebuild uuid -> FIRST-row index (duplicate slots of a segmented
        # audio must map to the first, not the last)
        self.rows = {}
        for i, e in enumerate(self.entries):
            self.rows.setdefault(e.uuid, i)
        self.uuid_rows = {
            u: [remap[r] for r in rws]
            for u, rws in self.uuid_rows.items()
            if u in self.rows
        }
        self.dead.clear()
        self.view_dead_pending.clear()
        self.dirty_from = min(self.dirty_from, doomed[0])
        self.view_clean_from = min(self.view_clean_from, doomed[0])


@dataclasses.dataclass
class TierView:
    """A tier's device view — what one matcher invocation scans.

    ``entries`` may include tombstoned (deleted) rows; their ``mask`` rows
    are all-False (and their lattice-map rows +inf), so they can never
    receive a vote — attribution by row index stays aligned without
    re-uploading the view on every delete."""

    tier_frames: int
    db: object  # jax [A_pad, T, C]
    mask: object  # jax [A_pad, T]
    n_audios: int  # view rows, INCLUDING tombstoned ones
    entries: list[AudioEntry]  # row order at view-build time
    value_map: object = None  # lazily-built lattice map [A_pad, K]
    # lazily-built uint8 companion of value_map for the certified lattice
    # prefilter (ops.match_lattice.quantize_value_map); derived from
    # value_map, maintained at the same mutation sites (append: quantize
    # the same rows; delete: scatter the 255 saturation sentinel)
    value_map_q: object = None
    # lazily-built per-coef scaled maps for the certified aligned
    # prefilter ({coef-index-tuple: (specs, maps)} —
    # ops.match_lattice.build_bound_maps); maintained incrementally on
    # append (new rows built + sliced in) and delete (+inf row scatter),
    # like value_map
    bound_maps: dict | None = None
    # lazily-built per-row global insertion seqs [A_pad] int32 on device
    # (the engine's device-side D5 tiebreak); padding rows = int32.max
    seq_dev: object = None
    # lazily-built per-row context ids [A_pad] int32 on device (the
    # context-filtered prefilter's keep key — ctx_ids_for); padding and
    # dead-at-build rows = -1 (no context id is negative)
    ctx_dev: object = None
    dead_rows: frozenset = frozenset()  # tombstoned row indices
    # per-row frame counts (== entry.n_frames except for auto-split audios,
    # whose segment rows repeat one entry — split_frames)
    row_frames: tuple = ()
    # row groups of auto-split audios; their lattice-map rows min-combine
    # into the first row (exact ∃t-over-whole-audio semantics)
    segments: tuple = ()
    # process-unique monotonic id: the engine's adaptive prefilter gate
    # keys its per-view miss counters on this (object ids can be recycled
    # by the allocator, which would carry a stale miss streak onto a
    # fresh view)
    gen: int = dataclasses.field(default_factory=itertools.count().__next__)


class FingerprintStore:
    """Tiered fingerprint matrices + catalog with reference CRUD semantics.

    Thread safety: a single re-entrant lock guards all mutation and catalog
    reads — the moral equivalent of the reference's SQLite busy handler
    (/root/reference/src/db_ctx_handler.c:122-140) without the retry loop.
    """

    def __init__(self, n_coefs: int = DEF_N_COEFS, mesh=None,
                 coef_weights=None) -> None:
        """``mesh``: optional ``jax.sharding.Mesh`` with a ``db`` axis; when
        set, device views are placed with a ``P('db')`` NamedSharding so
        every jitted consumer auto-partitions the audio axis via GSPMD.

        ``coef_weights``: the DSP chain's per-coef noise weighting
        (DspConfig.coef_weights) — recorded in the checkpoint catalog;
        a restore under DIFFERENT weights is rejected (the stored
        fingerprints live in the old weighted space)."""
        self.n_coefs = int(n_coefs)
        self.coef_weights = (
            tuple(float(x) for x in coef_weights) if coef_weights else None
        )
        self.mesh = mesh
        self._lock = threading.RLock()
        # serializes whole checkpoint saves; the store-wide _lock is held
        # only for the snapshot + segment writes, NOT for the O(DB) catalog
        # serialization (which would stall every search/ingest for seconds
        # on a 1M-track store)
        self._save_lock = threading.Lock()
        self.entries: list[AudioEntry] = []  # global insertion order
        self.contexts: dict[str, str] = {}  # name -> directory
        self._tiers: dict[int, _Tier] = {}
        self._views: list[TierView] | None = None  # cached per-tier views
        self._next_seq = 0  # insertion sequence counter (AudioEntry.seq)
        self._hash_index: dict[tuple[str, str], AudioEntry] = {}  # (ctx, md5)
        self._hash_count: dict[tuple[str, str], int] = {}  # dup-hash counts
        self._uuid_tier: dict[str, int] = {}
        self._by_uuid: dict[str, AudioEntry] = {}
        # dense per-process context ids (ctx_ids_for / ctx_id_for): the
        # context-filtered prefilter compares int rows on device instead
        # of shipping a fresh [A_pad] bool mask per (search, context) —
        # assigned on demand, never reused, not persisted (rebuilt lazily
        # after restore)
        self._ctx_ids: dict[str, int] = {}
        # incremental-checkpoint state: last save's directory, generation
        # counter, and per-tier segment manifest [[filename, n_rows], ...]
        self._save_dir: str | None = None
        self._save_gen = 0
        self._seg_manifest: dict[int, list[list]] = {}
        # restore provenance: the generation actually walked at load time
        # and the newest generation OBSERVED in the directory then (they
        # differ after a .bak fallback — _save_gen must stay 0 there so a
        # later save never reuses the damaged successor's segment files,
        # but a follower comparing against _save_gen alone would re-reload
        # the same fallback checkpoint on every poll)
        self._restored_gen = 0
        self._seen_gen = 0
        self._dirty = True

    # ------------------------------------------------------------------ #
    # context CRUD (fp_create_context_list_info / fp_delete_context_list_info,
    # /root/reference/src/fp_handler.c:912-1095)
    # ------------------------------------------------------------------ #

    def create_context(self, name: str, directory: str = "") -> None:
        if not name:
            raise ValueError("context name required")
        with self._lock:
            self.contexts[name] = directory

    def get_context(self, name: str) -> dict | None:
        with self._lock:
            if name not in self.contexts:
                return None
            return {"name": name, "directory": self.contexts[name]}

    def get_contexts_all(self) -> list[dict]:
        """``context_list`` rows (fp_get_context_lists_all, fp_handler.c:414)."""
        with self._lock:
            return [{"name": n, "directory": d} for n, d in self.contexts.items()]

    def delete_context(self, name: str) -> bool:
        """Delete a context and all its audios
        (fp_delete_context_list_info, /root/reference/src/fp_handler.c:1039)."""
        with self._lock:
            if name not in self.contexts:
                return False
            self.delete_audios(
                e.uuid for e in self.entries if e.context == name
            )
            del self.contexts[name]
            return True

    # ------------------------------------------------------------------ #
    # audio CRUD (fp_handler.c:115-197, 479-575)
    # ------------------------------------------------------------------ #

    def find_by_hash(self, context: str, file_hash: str) -> AudioEntry | None:
        """MD5 dedupe lookup (/root/reference/src/fp_handler.c:494-507,758-805).

        O(1) via a (context, hash) index — the analogue of the reference's
        audio_list indexes (fp_handler.c:736-753)."""
        with self._lock:
            return self._hash_index.get((context, file_hash))

    def add_audio(
        self,
        name: str,
        context: str,
        fingerprint: np.ndarray,
        file_hash: str,
        uuid: str | None = None,
        dedupe: bool = True,
    ) -> AudioEntry | None:
        """Insert one audio's fingerprint; returns None when deduped.

        Mirrors fp_craete_audio_list_info [sic] →
        create_audio_list_info + create_audio_fingerprint_info
        (/root/reference/src/fp_handler.c:161-197,479-575), with the per-frame
        INSERT loop replaced by one block write into the fitting tier.
        """
        fingerprint = np.asarray(fingerprint, dtype=np.float32)
        if fingerprint.ndim != 2 or fingerprint.shape[1] < self.n_coefs:
            raise ValueError(
                f"fingerprint must be [n_frames, >= {self.n_coefs}] "
                f"(got {fingerprint.shape})"
            )
        with self._lock:
            if context not in self.contexts:
                raise KeyError(f"unknown context {context!r}")
            if dedupe and self.find_by_hash(context, file_hash) is not None:
                return None
            if uuid is not None and uuid in self._by_uuid:
                # overwriting the index slots would orphan the old row:
                # live in every search view, undeletable, persisted forever
                raise ValueError(f"audio uuid {uuid!r} already exists")
            entry = AudioEntry(
                uuid=uuid or generate_uuid(),
                name=name,
                context=context,
                hash=file_hash,
                n_frames=int(fingerprint.shape[0]),
            )
            self._restore_entry(entry, fingerprint)
            self._dirty = True
            return entry

    def get_audio(self, uuid: str) -> AudioEntry | None:
        with self._lock:
            return self._by_uuid.get(uuid)

    def get_audios_by_context(self, context: str) -> list[AudioEntry]:
        """fp_get_audio_lists_by_contextname (/root/reference/src/fp_handler.c:441)."""
        with self._lock:
            return [e for e in self.entries if e.context == context]

    def get_fingerprint(self, uuid: str) -> np.ndarray | None:
        with self._lock:
            t = self._uuid_tier.get(uuid)
            if t is None:
                return None
            tier = self._tiers[t]
            i = tier.row_of(uuid)
            if i is None:
                return None
            rows = tier.uuid_rows.get(uuid, [i])
            if len(rows) == 1:
                return tier.matrix[i, : tier.row_frames[i]].copy()
            # over-long audio: reassemble its segment rows
            return np.concatenate(
                [tier.matrix[r, : tier.row_frames[r]] for r in rows]
            )

    def delete_audio(self, uuid: str) -> bool:
        """fp_delete_audio_list_info: removes the catalog row and all its
        fingerprint frames (/root/reference/src/fp_handler.c:115-159)."""
        with self._lock:
            return self._delete_audio_locked(uuid)

    def delete_audios(self, uuids) -> int:
        """Bulk delete: ONE matrix compaction per tier and ONE catalog
        rebuild, instead of per-uuid memmoves/list removals (O(k·N) data
        movement for k deletions). Returns the number actually deleted."""
        uuids = set(uuids)
        with self._lock:
            by_tier: dict[int, set[str]] = {}
            for u in uuids:
                t = self._uuid_tier.get(u)
                if t is not None:
                    by_tier.setdefault(t, set()).add(u)
            removed: list[AudioEntry] = []
            for t, us in by_tier.items():
                tier = self._tiers[t]
                for entry in tier.delete_many(us):
                    self._uuid_tier.pop(entry.uuid, None)
                    self._by_uuid.pop(entry.uuid, None)
                    removed.append(entry)
                if tier.should_compact():
                    tier.compact()
            if removed:
                # filter the catalog BEFORE the hash bookkeeping: the
                # duplicate-survivor scan in _forget_hash must only ever
                # see live entries, or it could re-point the index at an
                # already-deleted duplicate whose own _forget_hash ran
                # earlier in this loop
                removed_uuids = {e.uuid for e in removed}
                self.entries = [
                    e for e in self.entries if e.uuid not in removed_uuids
                ]
                for entry in removed:
                    self._forget_hash(entry)
                self._dirty = True
            return len(removed)

    def _delete_audio_locked(self, uuid: str) -> bool:
        t = self._uuid_tier.pop(uuid, None)
        if t is None:
            return False
        tier = self._tiers[t]
        entry = tier.delete(uuid)
        if entry is None:  # index out of sync — should not happen
            return False
        self.entries.remove(entry)
        self._by_uuid.pop(uuid, None)
        self._forget_hash(entry)
        if tier.should_compact():
            tier.compact()
        self._dirty = True
        return True

    def compact(self) -> None:
        """Force tombstone reclamation in every tier (admin maintenance
        op; normally automatic past the waste threshold)."""
        with self._lock:
            for tier in self._tiers.values():
                if tier.dead:
                    tier.compact()
                    self._dirty = True

    def _forget_hash(self, entry: AudioEntry) -> None:
        # Duplicate-hash entries can exist (add_audio with dedupe=False);
        # keep the index pointing at a surviving duplicate so find_by_hash
        # and sync-time dedupe stay correct. The per-key count makes the
        # unique-hash case (always, in practice) O(1) — the survivor scan
        # runs only when a duplicate actually survives. Callers must have
        # removed the deleted entries from self.entries BEFORE calling
        # (delete_audios filters first), so the scan only sees live rows.
        key = (entry.context, entry.hash)
        remaining = self._hash_count.get(key, 1) - 1
        if remaining <= 0:
            self._hash_count.pop(key, None)
            self._hash_index.pop(key, None)
        else:
            self._hash_count[key] = remaining
            if self._hash_index.get(key) is entry:
                survivor = next(
                    (
                        e for e in self.entries
                        if e is not entry
                        and e.context == entry.context
                        and e.hash == entry.hash
                    ),
                    None,
                )
                if survivor is None:  # count drift — never leave a stale ref
                    self._hash_index.pop(key, None)
                    self._hash_count.pop(key, None)
                else:
                    self._hash_index[key] = survivor

    # ------------------------------------------------------------------ #
    # device views
    # ------------------------------------------------------------------ #

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def frame_cap(self) -> int:
        """Largest live tier's frame capacity (0 when empty)."""
        with self._lock:
            live = [t for t, tier in self._tiers.items() if tier.n_live]
            return max(live, default=0)

    def _device_put(self, db: np.ndarray, mask: np.ndarray):
        import jax.numpy as jnp

        if self.mesh is None:
            return jnp.asarray(db), jnp.asarray(mask)
        from jax.sharding import PartitionSpec

        from tiresias_tpu.parallel.distributed import put_global

        # put_global handles multi-host meshes: each process materialises
        # only its addressable shards from the replicated host matrix
        return (
            put_global(db, self.mesh, PartitionSpec("db", None, None)),
            put_global(mask, self.mesh, PartitionSpec("db", None)),
        )

    def _a_pad(self, n: int) -> int:
        a_pad = _bucket(n, AUDIO_BUCKET)
        if self.mesh is not None:
            n_db = self.mesh.shape.get("db", 1)
            a_pad = _bucket(a_pad, AUDIO_BUCKET * n_db)
        return a_pad

    def search_views(self) -> list[TierView]:
        """Per-tier device views (tiers ascending). Cached until the store
        mutates; padding keeps jit recompiles bounded. A search scans every
        view and concatenates votes — exact, since audios are whole within
        one tier.

        Append-only mutations update the previous view IN PLACE on device
        (``dynamic_update_slice`` into new buffers): only the new rows
        cross host→device, so live ingest against a large serving DB costs
        O(delta), not a full re-upload. Deletes tombstone: the dead rows'
        mask (and lattice-map) rows are scattered off on device — O(deleted)
        work, never a re-upload. Only capacity growth or tombstone
        compaction falls back to a full rebuild."""
        with self._lock:
            if not self._dirty and self._views is not None:
                return self._views
            prev = {
                v.tier_frames: v for v in (self._views or [])
            }
            views: list[TierView] = []
            for t in sorted(self._tiers):
                tier = self._tiers[t]
                a = len(tier.entries)  # rows incl. tombstoned
                if a == 0:
                    continue
                a_pad = self._a_pad(a)
                old = prev.get(t)
                if (
                    old is not None
                    and old.db.shape[0] == a_pad
                    and a >= old.n_audios
                    and tier.view_clean_from >= old.n_audios
                ):
                    view = old
                    # rows tombstoned since the last view build: mask off on
                    # device (rows >= old.n_audios are covered by the
                    # extension's own dead check)
                    pending = {
                        r for r in tier.view_dead_pending if r < old.n_audios
                    }
                    if pending:
                        view = self._mask_off_rows(view, pending)
                    if a > view.n_audios:
                        view = self._extend_view(tier, view, a)
                    views.append(view)
                else:
                    db = np.full((a_pad, t, self.n_coefs), PAD_VALUE, np.float32)
                    db[:a] = tier.matrix[:a]
                    if tier.dead:
                        # value-masking for the Pallas kernels (they carry
                        # no mask operand — PAD_VALUE is the tombstone)
                        db[sorted(tier.dead)] = PAD_VALUE
                    n_frames = np.zeros(a_pad, dtype=np.int32)
                    n_frames[:a] = [
                        0 if i in tier.dead else nf
                        for i, nf in enumerate(tier.row_frames)
                    ]
                    mask = np.arange(t)[None, :] < n_frames[:, None]
                    db_j, mask_j = self._device_put(db, mask)
                    views.append(
                        TierView(
                            tier_frames=t,
                            db=db_j,
                            mask=mask_j,
                            n_audios=a,
                            entries=list(tier.entries),
                            dead_rows=frozenset(tier.dead),
                            row_frames=tuple(tier.row_frames),
                            segments=tuple(
                                tuple(r)
                                for r in tier.uuid_rows.values()
                            ),
                        )
                    )
                tier.view_clean_from = a
                tier.view_dead_pending = set()
            self._views = views
            self._dirty = False
            return views

    def _mask_off_rows(self, old: TierView, rows: set[int]) -> TierView:
        """Tombstone deleted rows in an existing device view: one scatter
        per buffer instead of a full rebuild + re-upload (the round-2
        delete stall). ALL THREE masking conventions must be updated —
        the XLA matcher masks by ``mask`` (→ all-False), the lattice by
        ``value_map`` (→ +inf), and the Pallas kernels by VALUE (db holds
        PAD_VALUE, which no tolerance band can reach)."""
        idx = np.fromiter(rows, np.int32, count=len(rows))
        mask = _scatter_rows(old.mask, idx, False, self.mesh)
        db = _scatter_rows(old.db, idx, np.float32(PAD_VALUE), self.mesh)
        vm = old.value_map
        if vm is not None:
            vm = _scatter_rows(vm, idx, np.float32(np.inf), self.mesh)
        vmq = old.value_map_q
        if vmq is not None:
            # the uint8 map's +inf is the 255 saturation sentinel
            vmq = _scatter_rows(vmq, idx, np.uint8(255), self.mesh)
        # prefilter bound maps are row-wise too: +inf dead rows can never
        # pass the bound, so the cached maps survive deletes without the
        # multi-second rebuild (same O(deleted) scatter as value_map)
        bms = old.bound_maps
        if bms is not None:
            # quantized (uint8) maps use the saturation sentinel as their
            # +inf (match_lattice.BOUND_FAR); float maps keep real inf
            def far(m):
                if np.issubdtype(np.dtype(m.dtype), np.floating):
                    return np.float32(np.inf)
                return np.dtype(m.dtype).type(np.iinfo(np.dtype(m.dtype)).max)

            bms = {
                key: (
                    specs,
                    tuple(
                        _scatter_rows(m, idx, far(m), self.mesh)
                        for m in maps
                    ),
                )
                for key, (specs, maps) in bms.items()
            }
        return TierView(
            tier_frames=old.tier_frames,
            db=db,
            mask=mask,
            n_audios=old.n_audios,
            entries=old.entries,
            value_map=vm,
            value_map_q=vmq,
            bound_maps=bms,
            # seq/ctx keys are row-positional and tombstoning changes no
            # rows; dead rows can't vote, so their stale values never win
            seq_dev=old.seq_dev,
            ctx_dev=old.ctx_dev,
            dead_rows=old.dead_rows | frozenset(rows),
            row_frames=old.row_frames,
            segments=old.segments,
        )

    def _extend_view(self, tier: "_Tier", old: TierView, a: int) -> TierView:
        """Append rows [old.n_audios, a) of a tier into its existing device
        view without re-uploading the rest (donated-buffer update)."""
        import jax
        import jax.numpy as jnp

        t = tier.t
        lo = old.n_audios
        if a == lo:  # mutation elsewhere (e.g. another tier) — reuse as-is
            return old
        # pad the delta row count to a power-of-two bucket (PAD rows are
        # masked out) so XLA compiles a bounded set of update shapes
        from tiresias_tpu.utils import next_pow2

        k_pad = min(next_pow2(a - lo), old.db.shape[0] - lo)
        new_rows = np.full((k_pad, t, self.n_coefs), PAD_VALUE, np.float32)
        new_rows[: a - lo] = tier.matrix[lo:a]
        n_frames = np.zeros(k_pad, dtype=np.int32)
        for i, nf in enumerate(tier.row_frames[lo:a]):
            # a row appended and tombstoned between two view builds arrives
            # here already dead — value-mask it (Pallas) AND frame-mask it
            if (lo + i) in tier.dead:
                new_rows[i] = PAD_VALUE
            else:
                n_frames[i] = nf
        new_mask = np.arange(t)[None, :] < n_frames[:, None]

        def to_dev(arr: np.ndarray):
            return _put_replicated(arr, self.mesh)

        db = _update_rows(old.db, to_dev(new_rows), lo, self.mesh)
        mask = _update_rows(old.mask, to_dev(new_mask), lo, self.mesh)
        # segments are added atomically under the store lock, so any
        # auto-split audio's rows lie entirely inside [lo, a) or before lo
        segments = tuple(tuple(r) for r in tier.uuid_rows.values())
        value_map = old.value_map
        if value_map is not None:
            # the lattice map is row-independent: build only the new rows
            from tiresias_tpu.ops.match_lattice import build_value_map

            vm_rows = build_value_map(
                to_dev(new_rows[..., 0]), to_dev(new_mask)
            )
            new_groups = [
                tuple(r - lo for r in g) for g in segments if g and g[0] >= lo
            ]
            vm_rows = _combine_segment_rows(vm_rows, new_groups, self.mesh)
            value_map = _update_rows(value_map, vm_rows, lo, self.mesh)
        value_map_q = old.value_map_q
        if value_map_q is not None:
            if value_map is None:
                value_map_q = None  # cannot derive without the f32 rows
            else:
                # derived map: quantize the same (segment-combined) rows
                # the f32 map just wrote
                from tiresias_tpu.ops.match_lattice import quantize_value_map

                value_map_q = _update_rows(
                    value_map_q, quantize_value_map(vm_rows), lo, self.mesh
                )
        # bound maps extend the same way (row-independent builds); segment
        # rows need no combining here — the aligned prefilter bails out of
        # any view with segments (engine._aligned_prefiltered)
        bound_maps = old.bound_maps
        if bound_maps is not None:
            from tiresias_tpu.ops.match_lattice import _build_bound_map

            new_bms = {}
            rows_by_spec = {}  # coef keys share specs — build each once
            for key, (specs, maps) in bound_maps.items():
                new_maps = []
                for spec, m in zip(specs, maps):
                    m_rows = rows_by_spec.get(spec)
                    if m_rows is None:
                        c, s, lo_c, hi_c, k_min, k_size = spec
                        m_rows = rows_by_spec[spec] = _build_bound_map(
                            to_dev(new_rows[..., c]), to_dev(new_mask),
                            s, lo_c, hi_c, k_min, k_size,
                        )
                    new_maps.append(_update_rows(m, m_rows, lo, self.mesh))
                new_bms[key] = (specs, tuple(new_maps))
            bound_maps = new_bms
        seq_dev = old.seq_dev
        if seq_dev is not None:
            # row-independent like the maps: only the new rows' seqs ship
            seq_new = np.full(k_pad, np.iinfo(np.int32).max, np.int32)
            seq_new[: a - lo] = [e.seq for e in tier.entries[lo:a]]
            seq_dev = _update_rows(seq_dev, to_dev(seq_new), lo, self.mesh)
        ctx_dev = old.ctx_dev
        if ctx_dev is not None:
            ctx_new = np.full(k_pad, -1, np.int32)
            ctx_new[: a - lo] = [
                -1 if (lo + i) in tier.dead
                else self._ctx_id_alloc(e.context)
                for i, e in enumerate(tier.entries[lo:a])
            ]
            ctx_dev = _update_rows(ctx_dev, to_dev(ctx_new), lo, self.mesh)
        return TierView(
            tier_frames=t,
            db=db,
            mask=mask,
            n_audios=a,
            entries=list(tier.entries),
            value_map=value_map,
            value_map_q=value_map_q,
            bound_maps=bound_maps,
            seq_dev=seq_dev,
            ctx_dev=ctx_dev,
            dead_rows=frozenset(tier.dead),
            row_frames=tuple(tier.row_frames),
            segments=segments,
        )

    def seq_for(self, view: TierView):
        """Per-row global insertion seqs for one view, on device
        ([A_pad] int32, padding rows int32.max) — the engine's
        device-side D5 tiebreak key (engine._device_ranked_batch).
        Cached on the view like value_map; append-extended in
        _extend_view, unchanged by tombstoning (dead rows can't vote)."""
        with self._lock:
            if view.seq_dev is not None:
                return view.seq_dev
            seqs = np.full(
                view.db.shape[0], np.iinfo(np.int32).max, np.int32
            )
            seqs[: view.n_audios] = [e.seq for e in view.entries]
        dev = _put_replicated(seqs, self.mesh)
        with self._lock:
            if view.seq_dev is None:
                view.seq_dev = dev
        return view.seq_dev

    def ctx_id_for(self, context: str) -> int:
        """Dense id of a context name (assigned on first use, stable for
        the process lifetime) — the scalar compared against
        :meth:`ctx_ids_for` rows on device. A name that is neither a live
        context nor previously seen returns the sentinel −2 (no row ever
        carries it, so the filtered search cleanly finds nothing) WITHOUT
        growing the map: the search op accepts client-supplied context
        strings, and allocating per unknown name would leak memory on a
        long-running server."""
        with self._lock:
            if (context not in self._ctx_ids
                    and context not in self.contexts):
                return -2
            return self._ctx_id_alloc(context)

    def _ctx_id_alloc(self, context: str) -> int:
        """Allocate-or-get a context id — the view builds use this (a ROW
        defines its context as real, so rows can never carry the −2
        sentinel that :meth:`ctx_id_for` hands unknown filter names)."""
        with self._lock:
            ids = self._ctx_ids
            if context not in ids:
                ids[context] = len(ids)
            return ids[context]

    def ctx_ids_for(self, view: TierView):
        """Per-row context ids for one view, on device ([A_pad] int32,
        padding and dead-at-build rows −1) — the context-filtered
        prefilter's keep key (engine._aligned_prefiltered). Cached on the
        view like seq_dev; append-extended in _extend_view; unchanged by
        tombstoning (a dead row's votes are already 0, so its stale id can
        never select, win, or block a certificate)."""
        with self._lock:
            if view.ctx_dev is not None:
                return view.ctx_dev
            ids = np.full(view.db.shape[0], -1, np.int32)
            ids[: view.n_audios] = [
                -1 if i in view.dead_rows
                else self._ctx_id_alloc(e.context)
                for i, e in enumerate(view.entries)
            ]
        dev = _put_replicated(ids, self.mesh)
        with self._lock:
            if view.ctx_dev is None:
                view.ctx_dev = dev
        return view.ctx_dev

    def value_map_for(self, view: TierView):
        """Lazily-built lattice distance map for one view (matmul fast path);
        cached on the view, which lives until the next mutation.

        Single-device stores build from the HOST tier matrix: the chunked
        fixed-shape build compiles once per frame tier, ever, instead of
        once per padded audio count (a compile stall after every
        capacity step). Meshed stores build
        from the sharded device view — GSPMD row-partitions the build.

        Snapshot isolation: the host fast path reads the LIVE tier matrix,
        which is only row-identical to the view while the view is still
        current. If the store has mutated since the snapshot was taken
        (e.g. a concurrent delete compacted rows), build from the view's
        own immutable device buffer instead — slower (per-shape compile)
        but always consistent with ``view.entries`` attribution."""
        from tiresias_tpu.ops.match_lattice import build_value_map

        with self._lock:
            if view.value_map is not None:
                return view.value_map
            is_current = (
                not self._dirty
                and self._views is not None
                and any(v is view for v in self._views)
            )
            if self.mesh is not None or not is_current:
                # view.db/mask are immutable device buffers — safe to read
                # outside the lock
                inputs = (view.db[..., 0], view.mask)
            else:
                # snapshot (copy) the live tier rows under the lock; the
                # multi-second chunked build at 100k-1M tracks then runs
                # WITHOUT the store-wide lock, so concurrent pushes, adds,
                # and searches don't block behind it
                t = view.tier_frames
                tier = self._tiers[t]
                a_pad, n = view.db.shape[0], view.n_audios
                db0 = np.full((a_pad, t), PAD_VALUE, np.float32)
                db0[:n] = tier.matrix[:n, :, 0]
                n_frames = np.zeros(a_pad, np.int32)
                n_frames[:n] = [
                    # tombstoned rows: all-masked -> +inf distances, so the
                    # lattice path can never vote for a deleted audio
                    0 if i in view.dead_rows else nf
                    for i, nf in enumerate(view.row_frames[:n])
                ]
                mask = np.arange(t)[None, :] < n_frames[:, None]
                inputs = (db0, mask)
        vm = _combine_segment_rows(
            build_value_map(*inputs), view.segments, self.mesh
        )
        with self._lock:
            if view.value_map is None:  # a concurrent build may have won
                view.value_map = vm
            return view.value_map

    def value_map_q_for(self, view: TierView):
        """uint8 companion of :meth:`value_map_for` for the certified
        lattice prefilter — derived from the exact f32 map by one fused
        device pass (ops.match_lattice.quantize_value_map), cached on the
        view and maintained incrementally at the same mutation sites
        (append quantizes the freshly-written rows, delete scatters the
        255 sentinel)."""
        from tiresias_tpu.ops.match_lattice import quantize_value_map

        with self._lock:
            if view.value_map_q is not None:
                return view.value_map_q
        vm = self.value_map_for(view)
        vmq = quantize_value_map(vm)
        with self._lock:
            if view.value_map_q is None:  # a concurrent build may have won
                view.value_map_q = vmq
            return view.value_map_q

    def bound_maps_for(self, view: TierView, coefs: int):
        """Prefilter bound maps for one view and search-coef count, cached
        on the view (like :meth:`value_map_for`; one entry per distinct
        ``coefs`` — typically a deployment uses one). Built from the
        view's own immutable device buffers — the mask already excludes
        tombstoned rows — so no snapshot subtleties. Cached maps survive
        view mutation: appends build only the new rows, deletes scatter
        +inf (see _extend_view / _mask_off_rows), so a live serving store
        never re-pays the full multi-second build."""
        from tiresias_tpu.ops.match_lattice import (
            bound_coef_indices,
            build_bound_maps,
        )

        key = bound_coef_indices(min(coefs, self.n_coefs))
        with self._lock:
            if view.bound_maps is None:
                view.bound_maps = {}
            cached = view.bound_maps.get(key)
        if cached is not None:
            return cached
        # view.db/mask are immutable device buffers, so the multi-second
        # chunked build (trace + compile + dispatch at 100k-1M tracks) runs
        # WITHOUT the store-wide lock — same discipline as value_map_for
        built = build_bound_maps(view.db, view.mask, coefs)
        with self._lock:
            if key not in view.bound_maps:  # a concurrent build may have won
                view.bound_maps[key] = built
            return view.bound_maps[key]

    def view_entries(self) -> list[AudioEntry]:
        """Catalog snapshot matching the concatenated view row order —
        result attribution must use THIS, not the live catalog, since a
        concurrent delete compacts rows and shifts indices."""
        with self._lock:
            views = self.search_views()
            out: list[AudioEntry] = []
            for v in views:
                out.extend(v.entries)
            return out

    def context_filter(self, context: str | None) -> np.ndarray | None:
        """Bool aligned with :meth:`view_entries` order (the concatenated
        UNPADDED vote columns) selecting a context's audios, or None for the
        reference's scan-everything behavior (PARITY.md D7)."""
        if context is None:
            return None
        with self._lock:
            return np.array(
                [e.context == context for e in self.view_entries()], dtype=bool
            )

    # ---- single-tier compatibility accessors (tests, tools) ----------- #

    def host_db(self) -> tuple[np.ndarray, np.ndarray]:
        """(db [A, T_max, C], mask [A, T_max]) dense numpy copy across all
        tiers, padded to the largest live tier — convenience for tests and
        tools; searches use :meth:`search_views`. Row order is the VIEW
        order (tiers ascending, insertion within — :meth:`view_entries`),
        NOT ``self.entries`` insertion order."""
        with self._lock:
            # live ROWS, not audios: an auto-split audio spans several rows
            a = sum(tier.n_live for tier in self._tiers.values())
            t = max(self.frame_cap, FRAME_BUCKET)
            db = np.full((a, t, self.n_coefs), PAD_VALUE, np.float32)
            order = []
            row_frames = []
            for tv in sorted(self._tiers):
                tier = self._tiers[tv]
                for i, e in enumerate(tier.entries):
                    if i in tier.dead:
                        continue
                    db[len(order), : tier.t] = tier.matrix[i]
                    order.append(e)
                    row_frames.append(tier.row_frames[i])
            n_frames = np.array(row_frames, dtype=np.int32)
            mask = (
                np.arange(t)[None, :] < n_frames[:, None]
                if a
                else np.zeros((0, t), bool)
            )
            return db, mask

    def device_db(self):
        """Single-view device arrays (db [A_pad, T, C], mask, n_audios).

        Valid only when all audios share one tier (the common homogeneous
        corpus); mixed-tier stores must use :meth:`search_views`."""
        views = self.search_views()
        if len(views) > 1:
            raise ValueError(
                "store spans multiple frame tiers; use search_views()"
            )
        if not views:
            import jax.numpy as jnp

            a_pad = self._a_pad(0)
            db = np.full(
                (a_pad, FRAME_BUCKET, self.n_coefs), PAD_VALUE, np.float32
            )
            mask = np.zeros((a_pad, FRAME_BUCKET), bool)
            db_j, mask_j = self._device_put(db, mask)
            return db_j, mask_j, 0
        v = views[0]
        return v.db, v.mask, v.n_audios

    def device_value_map(self):
        """Single-view lattice map — see :meth:`device_db` for the tier
        restriction."""
        views = self.search_views()
        if len(views) > 1:
            raise ValueError(
                "store spans multiple frame tiers; use search_views()"
            )
        if not views:
            raise ValueError("empty store has no value map")
        v = views[0]
        return self.value_map_for(v), v.n_audios

    # ------------------------------------------------------------------ #
    # checkpoint / resume (db_ctx_backup / db_ctx_load_db_data equivalents)
    # ------------------------------------------------------------------ #

    def save(self, directory: str) -> None:
        """Atomic, versioned, INCREMENTAL checkpoint (v3).

        Fingerprints live in immutable per-tier segment files
        (``tier<t>_seg<i>.g<gen>.npy``, ≤ SEGMENT_ROWS rows each); the
        catalog JSON lists exactly which files+row-counts form each tier
        and is the single atomic commit point (tmp+rename, previous
        generation kept as ``.bak``). Only segments whose rows changed
        since the last save are rewritten — per-ingest checkpoints cost
        O(new rows), not O(whole DB) (rows change only from ``dirty_from``
        to the end: appends append, deletes shift). Every written file is
        fsync'd before its rename and the directory fsync'd after the
        catalog commit, so the atomicity claim holds across power loss,
        not just process crashes. The store-wide lock is held only for the
        snapshot + dirty-segment writes (O(batch)); the O(DB) catalog JSON
        serialization runs outside it, so concurrent searches and ingest
        never stall behind a checkpoint of a large store. A crash at any
        point leaves both catalog generations referencing fully-written
        files (files are never modified in place). Replaces the
        reference's save-only-at-unload SQLite backup (PARITY.md D2;
        /root/reference/src/db_ctx_handler.c:673-717)."""
        with self._save_lock:
            self._save_locked(directory)

    def _save_locked(self, directory: str) -> None:
        rollback: dict[int, int] = {}  # tier -> pre-save dirty_from
        with self._lock:
            os.makedirs(directory, exist_ok=True)
            fresh = directory != self._save_dir
            # never collide with files another lineage in this directory
            # may still reference (immutability invariant). Checked on
            # EVERY save, not just fresh ones: a process that previously
            # owned this directory and later resumes saving (without the
            # engine's lock discipline) must not overwrite a successor
            # lineage's committed segments with same-named files.
            self._save_gen = max(self._save_gen, _max_seg_gen(directory))
            self._save_gen += 1
            gen = self._save_gen
            manifest: dict[int, list[list]] = {}
            for t, tier in sorted(self._tiers.items()):
                n = len(tier.entries)
                if n == 0:
                    continue
                old = [] if fresh else self._seg_manifest.get(t, [])
                dirty_from = 0 if fresh else tier.dirty_from
                segs: list[list] = []
                for s in range(-(-n // SEGMENT_ROWS)):
                    lo = s * SEGMENT_ROWS
                    hi = min(lo + SEGMENT_ROWS, n)
                    if (
                        hi <= dirty_from
                        and s < len(old)
                        and old[s][1] == hi - lo
                        and os.path.exists(os.path.join(directory, old[s][0]))
                    ):
                        segs.append([old[s][0], hi - lo])  # unchanged
                        continue
                    fname = f"tier{t}_seg{s}.g{gen}.npy"
                    tmp = os.path.join(directory, fname + ".tmp")
                    with open(tmp, "wb") as f:  # np.save(path) appends .npy
                        np.save(f, tier.matrix[lo:hi])
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, os.path.join(directory, fname))
                    segs.append([fname, hi - lo])
                manifest[t] = segs
                # mark clean NOW (segments are on disk) so mutations during
                # the unlocked catalog write re-dirty exactly their own rows;
                # rolled back if the catalog commit fails
                rollback[t] = dirty_from
                tier.dirty_from = n
            # lightweight snapshots (pointer copies; entries are immutable
            # once created) — the expensive serialization happens unlocked
            entries_snap = list(self.entries)
            contexts_snap = dict(self.contexts)
            dead_snap = {
                str(t): sorted(self._tiers[t].dead)
                for t in manifest
                if self._tiers[t].dead
            }
        try:
            catalog = {
                "version": CHECKPOINT_VERSION,
                "n_coefs": self.n_coefs,
                "coef_weights": (
                    list(self.coef_weights) if self.coef_weights else None
                ),
                "gen": gen,
                "contexts": contexts_snap,
                "entries": [e.to_dict() for e in entries_snap],
                "tiers": {str(t): segs for t, segs in manifest.items()},
                # v4: tombstoned rows stay in their segments (no rewrite on
                # delete — the save stays O(new rows)); load drops them
                "dead": dead_snap,
            }
            cat_path = os.path.join(directory, CATALOG_FILE)
            cat_tmp = cat_path + ".tmp"
            with open(cat_tmp, "w") as f:
                json.dump(catalog, f, separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(cat_path):
                if fresh:
                    self._pair_legacy_backup(directory, cat_path)
                if _readable_catalog(cat_path):
                    os.replace(cat_path, cat_path + ".bak")
                else:
                    # the outgoing current generation is CORRUPT (this
                    # store restored from .bak, or a fresh lineage saves
                    # over a damaged directory): rotating it would clobber
                    # the last-known-good backup and _gc_segments would
                    # then unlink that generation's files — a transient
                    # read error must never become permanent data loss
                    log.warning(
                        "not rotating corrupt catalog over the good "
                        "backup generation in %s", directory,
                    )
                    os.unlink(cat_path)
            os.replace(cat_tmp, cat_path)
            _fsync_dir(directory)
        except BaseException:
            with self._lock:
                for t, df in rollback.items():
                    tier = self._tiers.get(t)
                    if tier is not None:
                        tier.dirty_from = min(tier.dirty_from, df)
            raise
        with self._lock:
            self._seg_manifest = manifest
            self._save_dir = directory
        self._gc_segments(directory)
        log.debug("checkpointed %d audios to %s", len(entries_snap), directory)

    @staticmethod
    def _pair_legacy_backup(directory: str, cat_path: str) -> None:
        """Keep the ``.bak`` (catalog, matrix) PAIR consistent when the
        first v3 save rotates a v1/v2 catalog.

        Legacy saves rotated ``catalog.json`` and ``fingerprints.npz``
        together; a v3 save rotates only the catalog, which would pair the
        newest legacy catalog with the second-newest legacy matrix — a
        broken (or, worse, silently wrong) fallback generation. Copy (not
        move: a crash mid-upgrade must leave the current legacy pair
        intact) the matrix the rotating catalog references to ``.bak``.
        Runs only on the first save into a directory (``fresh``), so
        steady-state saves never re-read the catalog."""
        legacy = os.path.join(directory, MATRIX_FILE)
        if not os.path.exists(legacy):
            return
        try:
            with open(cat_path) as f:
                old_version = json.load(f).get("version", 0)
        except Exception:  # noqa: BLE001 - unreadable old catalog
            return
        if old_version not in (1, 2):
            return
        import shutil

        tmp = legacy + ".bak.tmp"
        shutil.copyfile(legacy, tmp)
        # fsync the copied DATA before the rename: the fallback pair this
        # function exists to keep consistent must survive power loss too
        # (save()'s directory fsync persists only the name)
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)
        os.replace(tmp, legacy + ".bak")

    @staticmethod
    def _referenced_segments(cat_path: str) -> set[str]:
        try:
            with open(cat_path) as f:
                cat = json.load(f)
            return {
                seg[0]
                for segs in cat.get("tiers", {}).values()
                for seg in segs
            }
        except Exception:  # noqa: BLE001 - unreadable generation
            return set()

    def _gc_segments(self, directory: str) -> None:
        """Unlink segment files referenced by neither catalog generation."""
        cat_path = os.path.join(directory, CATALOG_FILE)
        live = self._referenced_segments(cat_path) | self._referenced_segments(
            cat_path + ".bak"
        )
        for name in os.listdir(directory):
            if (
                name.startswith("tier")
                and (name.endswith(".npy") or name.endswith(".npy.tmp"))
                and name not in live
            ):
                try:
                    os.unlink(os.path.join(directory, name))
                except OSError:
                    pass

    @staticmethod
    def load(
        directory: str, n_coefs: int = DEF_N_COEFS, mesh=None,
        coef_weights=None,
    ) -> "FingerprintStore":
        """Restore from a checkpoint; empty store when none exists — the
        restore-on-load path (/root/reference/src/fp_handler.c:80-87).
        A corrupted current generation falls back to ``*.bak``; when
        generations EXIST but none is readable, raises
        :class:`CheckpointUnreadable` instead of returning an empty store
        (whose next save would rotate + GC the existing data away —
        a transient read error must never become permanent data loss)."""
        store = FingerprintStore(n_coefs=n_coefs, mesh=mesh,
                                 coef_weights=coef_weights)
        errors: list[str] = []
        for suffix in ("", ".bak"):
            cat_path = os.path.join(directory, CATALOG_FILE + suffix)
            if not os.path.exists(cat_path):
                continue
            try:
                loaded = FingerprintStore._load_catalog(
                    directory, cat_path, suffix, n_coefs, mesh,
                    coef_weights,
                )
                loaded._seen_gen = loaded._restored_gen
                if suffix:
                    # .bak fallback: record the damaged CURRENT catalog's
                    # generation (when its JSON is at least parseable) so
                    # a follower doesn't mistake it for news on every poll
                    cur = _read_catalog_gen(
                        os.path.join(directory, CATALOG_FILE)
                    )
                    loaded._seen_gen = max(loaded._seen_gen, cur)
                return loaded
            except CheckpointIncompatible:
                raise  # incompatible checkpoint: fail loudly, don't mask
            except Exception as exc:  # noqa: BLE001 - corrupt generation
                errors.append(f"{suffix or 'current'}: {exc}")
                log.warning(
                    "checkpoint generation %r unreadable, trying previous",
                    suffix or "current",
                )
        if errors:
            raise CheckpointUnreadable(
                f"checkpoint in {directory!r} exists but no generation is "
                f"readable ({'; '.join(errors)}); refusing to start empty — "
                "repair or move the directory aside to start fresh"
            )
        return store

    @staticmethod
    def read_catalog_metadata(directory: str) -> dict | None:
        """Catalog metadata (contexts + audio-entry dicts) WITHOUT loading
        any segment data — the cheap path for read-only listings
        (``tiresias show ...`` against a multi-GB checkpoint must not
        deserialize every fingerprint tier just to print a table).
        Returns None when no checkpoint exists; same generation fallback
        and :class:`CheckpointUnreadable` semantics as :meth:`load`."""
        errors: list[str] = []
        for suffix in ("", ".bak"):
            cat_path = os.path.join(directory, CATALOG_FILE + suffix)
            if not os.path.exists(cat_path):
                continue
            try:
                with open(cat_path) as f:
                    catalog = json.load(f)
                if catalog.get("version") not in (1, 2, 3, 4):
                    raise CheckpointIncompatible(
                        f"unsupported checkpoint version {catalog.get('version')}"
                    )
                return {
                    "contexts": dict(catalog["contexts"]),
                    "entries": list(catalog["entries"]),
                    "gen": int(catalog.get("gen", 0)),
                }
            except CheckpointIncompatible:
                raise
            except Exception as exc:  # noqa: BLE001 - corrupt generation
                errors.append(f"{suffix or 'current'}: {exc}")
        if errors:
            raise CheckpointUnreadable(
                f"checkpoint in {directory!r} exists but no generation is "
                f"readable ({'; '.join(errors)})"
            )
        return None

    @staticmethod
    def _load_catalog(
        directory, cat_path, suffix, n_coefs, mesh, coef_weights=None
    ) -> "FingerprintStore":
        store = FingerprintStore(n_coefs=n_coefs, mesh=mesh,
                                 coef_weights=coef_weights)
        with open(cat_path) as f:
            catalog = json.load(f)
        version = catalog.get("version")
        if version not in (1, 2, 3, 4):
            raise CheckpointIncompatible(
                f"unsupported checkpoint version {version}"
            )
        if int(catalog["n_coefs"]) != store.n_coefs:
            raise CheckpointIncompatible(
                f"checkpoint has n_coefs={catalog['n_coefs']}, store wants {n_coefs}"
            )
        ckpt_w = catalog.get("coef_weights")
        ckpt_w = tuple(float(x) for x in ckpt_w) if ckpt_w else None
        if ckpt_w != store.coef_weights:
            raise CheckpointIncompatible(
                f"checkpoint fingerprints live in coef_weights={ckpt_w} "
                f"space, config wants {store.coef_weights} — stored "
                "values would be stale; rebuild with a fresh data_dir"
            )
        entries = [AudioEntry.from_dict(d) for d in catalog["entries"]]
        store.contexts = dict(catalog["contexts"])
        if version in (3, 4):
            # v3/v4: per-tier segment files listed by the catalog manifest
            tiers: dict[int, np.ndarray] = {}
            for t_str, segs in catalog["tiers"].items():
                parts = []
                for fname, n_rows in segs:
                    arr = np.load(os.path.join(directory, fname))
                    if arr.shape[0] != n_rows:
                        raise ValueError(
                            f"segment {fname}: {arr.shape[0]} rows, "
                            f"manifest says {n_rows}"
                        )
                    parts.append(arr.astype(np.float32))
                tiers[int(t_str)] = (
                    np.concatenate(parts)
                    if parts
                    else np.zeros((0, int(t_str), store.n_coefs), np.float32)
                )
            dead = {
                int(t): set(rows)
                for t, rows in catalog.get("dead", {}).items()
            }
            FingerprintStore._walk_tiered(store, entries, tiers, dead)
            store._restored_gen = int(catalog.get("gen", 0))
            # a current-generation restore can extend its own manifest on
            # the next save; a .bak restore must not reuse newer-gen files
            if suffix == "":
                store._save_dir = directory
                store._save_gen = int(catalog.get("gen", 0))
                store._seg_manifest = {
                    int(t): [list(s) for s in segs]
                    for t, segs in catalog["tiers"].items()
                }
                for t, tier in store._tiers.items():
                    # tombstones were compacted away during the walk: from
                    # the first dead MANIFEST row on, in-memory rows no
                    # longer match the segment files — rewrite from there
                    d = dead.get(t)
                    tier.dirty_from = (
                        min(d) if d else len(tier.entries)
                    )
        else:
            mat_path = os.path.join(directory, MATRIX_FILE + suffix)
            with np.load(mat_path) as data:
                if version == 1:
                    # v1: one dense matrix in global insertion order
                    matrix = data["matrix"].astype(np.float32)
                    if matrix.shape[0] != len(entries):
                        # torn generations (crash between the two renames):
                        # corruption, not incompatibility — caller falls back
                        raise ValueError(
                            "checkpoint catalog/matrix row count mismatch"
                        )
                    for i, e in enumerate(entries):
                        store._restore_entry(e, matrix[i, : e.n_frames])
                else:
                    # v2: one matrix per tier, rows in tier insertion order
                    tiers = {
                        int(k.split("_", 1)[1]): data[k].astype(np.float32)
                        for k in data.files
                    }
                    FingerprintStore._walk_tiered(store, entries, tiers)
        store._dirty = True
        log.debug("restored %d audios from %s", len(store.entries), cat_path)
        return store

    @staticmethod
    def _walk_tiered(store, entries, tiers, dead=None) -> None:
        """Restore a flat catalog whose fingerprints sit in per-tier
        matrices, rows in per-tier insertion order. ``dead`` maps tier ->
        tombstoned row indices (v4); those rows are skipped (compacted
        away) during the walk."""
        dead = dead or {}
        cursors: dict[int, int] = {}

        def next_row(t: int) -> int:
            row = cursors.get(t, 0)
            dt = dead.get(t, ())
            while row in dt:
                row += 1
            if t not in tiers or row >= tiers[t].shape[0]:
                raise ValueError("checkpoint catalog/matrix tier mismatch")
            cursors[t] = row + 1
            return row

        for e in entries:
            segs = split_frames(e.n_frames)
            if len(segs) == 1:
                t = tier_for(e.n_frames)
                store._restore_entry(e, tiers[t][next_row(t), : e.n_frames])
            else:
                # auto-split audio: consecutive segment rows in the top tier
                t = MAX_TIER_FRAMES
                fp = np.concatenate(
                    [tiers[t][next_row(t), :n] for n in segs]
                )
                store._restore_entry(e, fp)

    def _restore_entry(self, entry: AudioEntry, fingerprint: np.ndarray) -> None:
        entry.seq = self._next_seq
        self._next_seq += 1
        segs = split_frames(entry.n_frames)
        t = MAX_TIER_FRAMES if len(segs) > 1 else tier_for(entry.n_frames)
        tier = self._tiers.get(t)
        if tier is None:
            tier = self._tiers[t] = _Tier(t, self.n_coefs)
        if len(segs) == 1:
            tier.add(entry, fingerprint[:, : self.n_coefs])
        else:
            tier.add_segmented(entry, fingerprint[:, : self.n_coefs], segs)
        self.entries.append(entry)
        key = (entry.context, entry.hash)
        self._hash_index[key] = entry
        self._hash_count[key] = self._hash_count.get(key, 0) + 1
        self._uuid_tier[entry.uuid] = t
        self._by_uuid[entry.uuid] = entry

    # convenience for tests / tools
    def iter_entries(self) -> Iterable[AudioEntry]:
        with self._lock:
            return list(self.entries)


def _fsck_walk_tiers(
    directory: str, catalog: dict, n_coefs: int,
    tiers_report: dict, referenced: set,
) -> None:
    """Structural walk of one v3/v4 catalog's tier manifest (fsck); any
    malformed shape raises and the caller reports the generation BAD."""
    tiers = catalog.get("tiers", {})
    if not isinstance(tiers, dict):
        raise ValueError(f"'tiers' is {type(tiers).__name__}, expected object")
    dead_map = catalog.get("dead", {})
    if not isinstance(dead_map, dict):
        raise ValueError(f"'dead' is {type(dead_map).__name__}, expected object")
    for t_key, segs in tiers.items():
        t = int(t_key)
        rows_total = 0
        t_errors: list[str] = []
        for fname, n_rows in segs:
            referenced.add(str(fname))
            path = os.path.join(directory, str(fname))
            n_rows = int(n_rows)
            if not os.path.exists(path):
                t_errors.append(f"{fname}: missing")
                continue
            try:
                arr = np.load(path, mmap_mode="r")
                shape, dtype = arr.shape, arr.dtype
                del arr
            except Exception as exc:  # noqa: BLE001 - torn/short file
                t_errors.append(f"{fname}: unreadable ({exc})")
                continue
            if shape != (n_rows, t, n_coefs):
                t_errors.append(
                    f"{fname}: shape {shape} != catalog "
                    f"({n_rows}, {t}, {n_coefs})"
                )
            elif dtype != np.float32:
                t_errors.append(f"{fname}: dtype {dtype} != float32")
            rows_total += n_rows
        dead = dead_map.get(t_key, [])
        bad_dead = [d for d in dead if not 0 <= int(d) < rows_total]
        if bad_dead:
            t_errors.append(
                f"dead rows out of range {bad_dead[:5]} (rows={rows_total})"
            )
        tiers_report[t] = {
            "segments": len(segs),
            "rows": rows_total,
            "dead": len(dead),
            "errors": t_errors,
        }


def fsck_checkpoint(
    directory: str, deep: bool = False, n_coefs: int | None = None
) -> dict:
    """Offline checkpoint integrity check (the ``tiresias fsck`` command).

    The reference's persistence is one SQLite file whose integrity is
    whatever ``PRAGMA integrity_check`` says inside a running Asterisk;
    this store's checkpoint is a catalog JSON + immutable segment files
    per generation, so a broken disk/partial copy is verifiable OFFLINE
    without touching a serving process.

    Per generation ("current" and ".bak"): catalog parses, version known,
    every v3/v4 manifest segment file exists with the exact shape/dtype
    the catalog claims (header-only ``np.load(mmap_mode="r")`` — no data
    read), dead-row indices in range. Plus orphan detection: ``.npy``
    files no generation references (GC debris from a crash between
    segment write and catalog commit — harmless, reclaimable). ``deep``
    additionally performs a full :meth:`FingerprintStore.load` of the
    directory (the exact restore a server would run, incl. the
    generation-fallback rules).

    ``n_coefs`` is the deployment's configured coefficient count (what a
    real server startup passes to :meth:`FingerprintStore.load`); the
    deep restore uses it so a config/checkpoint mismatch reports BAD here
    exactly as the startup would fail. None falls back to each catalog's
    own value (structure-only checking).

    Returns a report dict; ``report["ok"]`` is True when the newest
    readable generation is structurally sound (a server restart would
    serve it) — a damaged current with a clean ``.bak`` is ok=False:
    data SINCE the .bak would be lost silently on restart.
    """
    report: dict = {"directory": directory, "generations": {}, "ok": False}
    referenced: set = set()
    for suffix, label in (("", "current"), (".bak", "bak")):
        cat_path = os.path.join(directory, CATALOG_FILE + suffix)
        if not os.path.exists(cat_path):
            report["generations"][label] = None
            continue
        gen_report: dict = {"ok": False, "errors": []}
        report["generations"][label] = gen_report
        try:
            with open(cat_path) as f:
                catalog = json.load(f)
            if not isinstance(catalog, dict):
                raise ValueError(
                    f"top-level {type(catalog).__name__}, expected object"
                )
        except Exception as exc:  # noqa: BLE001 - corrupt generation
            gen_report["errors"].append(f"catalog unreadable: {exc}")
            continue
        version = catalog.get("version")
        gen_report.update(
            version=version,
            gen=int(catalog.get("gen", 0) or 0),
            entries=len(catalog.get("entries", [])),
            contexts=len(catalog.get("contexts", {})),
        )
        if version not in (1, 2, 3, 4):
            gen_report["errors"].append(f"unsupported version {version!r}")
            continue
        cat_coefs = int(catalog.get("n_coefs", DEF_N_COEFS) or DEF_N_COEFS)
        n_coefs_gen = cat_coefs if n_coefs is None else int(n_coefs)
        if n_coefs is not None and cat_coefs != n_coefs_gen:
            gen_report["errors"].append(
                f"checkpoint has n_coefs={cat_coefs}, deployment config "
                f"wants {n_coefs_gen} (a server startup would refuse)"
            )
        if version < 3:
            # legacy monolithic layout: one npz next to the catalog
            npz = os.path.join(directory, "fingerprints.npz" + suffix)
            if not os.path.exists(npz):
                gen_report["errors"].append(
                    f"legacy v{version} fingerprints.npz{suffix} missing"
                )
            gen_report["ok"] = not gen_report["errors"]
            continue
        tiers_report: dict = {}
        gen_report["tiers"] = tiers_report
        try:
            _fsck_walk_tiers(
                directory, catalog, n_coefs_gen, tiers_report, referenced
            )
        except Exception as exc:  # noqa: BLE001 - malformed catalog shape
            # the tool exists to DIAGNOSE corrupt checkpoints: any
            # unexpected structure (tiers as a scalar, non-numeric keys,
            # garbage row counts) is a finding, not a crash
            gen_report["errors"].append(f"catalog malformed: {exc}")
        for t in tiers_report.values():
            gen_report["errors"].extend(t["errors"])
        gen_report["ok"] = not gen_report["errors"]
    # orphans: segment files neither generation references (crash debris
    # between a segment write and its catalog commit; or a GC'd lineage)
    orphans = [
        f
        for f in os.listdir(directory)
        if f.endswith(".npy") and f not in referenced
    ] if os.path.isdir(directory) else []
    report["orphans"] = {
        "count": len(orphans),
        "bytes": sum(
            os.path.getsize(os.path.join(directory, f)) for f in orphans
        ),
    }
    cur = report["generations"].get("current")
    report["ok"] = bool(cur and cur["ok"])
    if deep:
        deep_report: dict = {"ok": False}
        report["deep"] = deep_report
        try:
            deep_coefs = n_coefs
            if deep_coefs is None:
                # structure-only mode: take the newest readable catalog's
                # own value so a default-less run still restores
                for label in ("current", "bak"):
                    g = report["generations"].get(label)
                    if g and "version" in g and g.get("version"):
                        suffix = "" if label == "current" else ".bak"
                        with open(
                            os.path.join(directory, CATALOG_FILE + suffix)
                        ) as f:
                            deep_coefs = int(
                                json.load(f).get("n_coefs", DEF_N_COEFS)
                            )
                        break
                deep_coefs = deep_coefs or DEF_N_COEFS
            store = FingerprintStore.load(directory, n_coefs=deep_coefs)
            deep_report.update(
                ok=True, entries=len(store), gen=store._restored_gen,
                contexts=len(store.contexts),
            )
        except Exception as exc:  # noqa: BLE001 - any restore failure
            deep_report["error"] = str(exc)
        report["ok"] = report["ok"] and deep_report["ok"]
    return report
