"""parallel subpackage of tiresias: mesh + shard_map scale-out."""

from tiresias_tpu.parallel.distributed import (
    global_mesh,
    initialize_distributed,
    is_multiprocess,
    put_global,
)
from tiresias_tpu.parallel.sharding import (
    BATCH_AXIS,
    DB_AXIS,
    make_mesh,
    shard_db,
    sharded_fingerprint,
    sharded_fingerprint_long,
    sharded_search,
    sharded_votes_pallas,
)

__all__ = [
    "BATCH_AXIS",
    "DB_AXIS",
    "global_mesh",
    "initialize_distributed",
    "is_multiprocess",
    "make_mesh",
    "put_global",
    "shard_db",
    "sharded_fingerprint",
    "sharded_fingerprint_long",
    "sharded_search",
    "sharded_votes_pallas",
]
