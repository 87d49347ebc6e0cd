"""engine subpackage of tiresias: catalog/filesystem sync + ingest."""

from tiresias_tpu.engine.sync import (
    SyncReport,
    delete_removed_audio,
    hash_directory,
    ingest_files,
    scan_directory,
    sync_all,
    sync_context_audio,
    sync_contexts,
)

__all__ = [
    "SyncReport",
    "delete_removed_audio",
    "hash_directory",
    "ingest_files",
    "scan_directory",
    "sync_all",
    "sync_context_audio",
    "sync_contexts",
]
