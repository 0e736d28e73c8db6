"""The serving engine: meshless, or sharded over a mesh (routed and
degraded serving, shard health, fault injection)."""
