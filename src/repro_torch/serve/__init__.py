"""Serving: the fault-tolerance policy of the engine's shard owners."""
