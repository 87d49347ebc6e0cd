"""tiresias: accelerator-native audio fingerprinting and recognition.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``pchero/asterisk-tiresias`` (an Asterisk C module that fingerprints audio
with aubio MFCCs and matches live audio against a SQLite DB). Nothing is
translated: the MFCC chain is one batched XLA program on the device, the
SQLite match loop is an HBM-resident fingerprint matrix with fused
tolerance-vote kernels (Triton on the GPU), and streaming recognition is a batched sliding-window scorer.
"""

from tiresias_tpu.config import (
    DspConfig,
    MatchConfig,
    ContextConfig,
    TiresiasConfig,
    load_config,
)

__version__ = "0.1.0"

__all__ = [
    "DspConfig",
    "MatchConfig",
    "ContextConfig",
    "TiresiasConfig",
    "load_config",
    "__version__",
]
