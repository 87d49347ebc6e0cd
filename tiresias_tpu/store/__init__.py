"""store subpackage of tiresias: HBM fingerprint matrix + host catalog."""

from tiresias_tpu.store.fingerprint_store import (
    AudioEntry,
    FingerprintStore,
    AUDIO_BUCKET,
    FRAME_BUCKET,
)

__all__ = ["AudioEntry", "FingerprintStore", "AUDIO_BUCKET", "FRAME_BUCKET"]
