"""models subpackage of tiresias: the analysis-model registry.

This framework's "model families" are fingerprint analysis profiles — named
(DspConfig, MatchConfig) presets over the same kernel stack (the reference
hardcodes exactly one, /root/reference/src/fp_handler.c:33-41). Defined in
:mod:`tiresias_tpu.profiles` and re-exported here.
"""

from tiresias_tpu.profiles import (
    MUSIC,
    PROFILES,
    TELEPHONY,
    WIDEBAND,
    Profile,
    get_profile,
)

__all__ = [
    "MUSIC",
    "PROFILES",
    "TELEPHONY",
    "WIDEBAND",
    "Profile",
    "get_profile",
]
