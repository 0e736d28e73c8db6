"""Exception types of the engine's resilience envelope.

``TransientShardError`` is what the engine's bounded-retry loop catches;
``BackpressureError`` is raised when the cache-miss dispatch queue exceeds
``EngineConfig.queue_budget``. Shard liveness tracking (``ShardHealth`` in
``repro.serve.health``) comes with sharded serving, ROADMAP A12.
"""


class TransientShardError(RuntimeError):
    """A per-batch dispatch failure worth retrying (with backoff)."""


class BackpressureError(RuntimeError):
    """The dispatch queue exceeded the engine's queue budget; shed load."""
