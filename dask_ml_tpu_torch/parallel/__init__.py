"""Data placement of the port: one device per process (``sharded.py``),
the process plane (``distributed.py``, ``mesh.py``) and row-partitioned
frames (``frames.py``, pandas imported on its paths only)."""

from .frames import PartitionedFrame, from_pandas
from .sharded import ShardedArray, as_sharded

__all__ = ["PartitionedFrame", "ShardedArray", "as_sharded", "from_pandas"]
