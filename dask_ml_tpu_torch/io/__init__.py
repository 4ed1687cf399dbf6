"""Native host I/O of the port: the CSV loader and the readahead block
reader (``io/native.py``)."""
from .native import (NativeBlockReader, load_library, read_csv_f32,
                     read_csv_sharded)

__all__ = ["NativeBlockReader", "load_library", "read_csv_f32",
           "read_csv_sharded"]
