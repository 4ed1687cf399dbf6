"""Data placement of the port: one device, see ``sharded.py``."""

from .sharded import ShardedArray, as_sharded

__all__ = ["ShardedArray", "as_sharded"]
