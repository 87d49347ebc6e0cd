"""api subpackage of tiresias: the library front door."""

from tiresias_tpu.api.engine import (
    NOT_FOUND,
    STATUS_FOUND,
    STATUS_HANGUP,
    STATUS_NOTFOUND,
    SearchResult,
    Tiresias,
)

__all__ = [
    "NOT_FOUND",
    "STATUS_FOUND",
    "STATUS_HANGUP",
    "STATUS_NOTFOUND",
    "SearchResult",
    "Tiresias",
]
