#!/usr/bin/env python3
"""Measure the host's copy rates that bound a streamed pass.

    python3 scripts/host_copy_rates.py

Builds ``scripts/host_copy_rates.cpp`` with the host compiler into a
temporary directory, writes a 1 GiB file into the temporary directory
and into the working directory in turn, and prints for 1, 4 and 8
threads: ``pread`` into a faulted buffer in 1 MiB and 32 MiB calls,
``memcpy`` out of a mapping of the file, ``memcpy`` between pageable
and pinned host memory (pinned on a machine with a card), torch's copy
of the memmap into pinned memory (the stream's copy route), the rate of
faulting and filling fresh memory, and three sequential reads of the
file through one port block reader into pinned memory (its first
pass fills the mapping's page tables), on 4 and 8 threads. Also the mounts and the CPU count the rates depend on.
"""

import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

NBYTES = 1 << 30


def _lib(tmp):
    so = os.path.join(tmp, "host_copy_rates.so")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-pthread",
                    "-std=c++17", "-o", so,
                    os.path.join(HERE, "host_copy_rates.cpp")], check=True)
    lib = ctypes.CDLL(so)
    for f in ("t_pread", "t_mmap", "t_memcpy"):
        getattr(lib, f).restype = ctypes.c_double
    lib.t_pread.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                            ctypes.c_int64, ctypes.c_int, ctypes.c_int64]
    lib.t_mmap.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int]
    lib.t_memcpy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int64, ctypes.c_int]
    return lib


def _rates(lib, d):
    from dask_ml_tpu_torch.io import NativeBlockReader

    path = os.path.join(d, "host_copy_rates.bin")
    with open(path, "wb") as f:
        for _ in range(NBYTES >> 26):
            f.write(np.random.default_rng(0).bytes(1 << 26))
    pin = torch.cuda.is_available()
    buf = np.ones(NBYTES, np.uint8)
    pinned = torch.empty(NBYTES, dtype=torch.uint8, pin_memory=pin)
    pinned.fill_(1)
    print("dir", d)
    for T in (1, 4, 8):
        for chunk in (1 << 20, 32 << 20):
            s = min(lib.t_pread(path.encode(), buf.ctypes.data, NBYTES, T,
                                chunk) for _ in range(2))
            print(f"  pread T={T} chunk={chunk >> 20}MB: "
                  f"{NBYTES / s / 1e9:.2f} GB/s")
        s = min(lib.t_mmap(path.encode(), buf.ctypes.data, NBYTES, T)
                for _ in range(2))
        print(f"  mmap+memcpy T={T}: {NBYTES / s / 1e9:.2f} GB/s")
        s = min(lib.t_memcpy(pinned.data_ptr(), buf.ctypes.data, NBYTES, T)
                for _ in range(2))
        print(f"  memcpy pageable->pinned T={T}: {NBYTES / s / 1e9:.2f} GB/s")
        s = min(lib.t_memcpy(buf.ctypes.data, pinned.data_ptr(), NBYTES, T)
                for _ in range(2))
        print(f"  memcpy pinned->pageable T={T}: {NBYTES / s / 1e9:.2f} GB/s")
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    for _ in range(2):
        t = time.perf_counter()
        pinned.copy_(torch.from_numpy(np.array(mm, copy=False)))
        s = time.perf_counter() - t
    print(f"  torch copy_ memmap->pinned: {NBYTES / s / 1e9:.2f} GB/s")
    t = time.perf_counter()
    np.ones(NBYTES, np.uint8)
    s = time.perf_counter() - t
    print(f"  fresh 1 GB np.ones (fault+fill): {NBYTES / s / 1e9:.2f} GB/s")
    mmf = np.memmap(path, dtype=np.float32, mode="r",
                    shape=(NBYTES // 1024, 256))
    dst = torch.empty((65536, 256), pin_memory=pin)
    for threads in (4, 8):
        with NativeBlockReader(mmf, 65536, threads=threads) as r:
            for rep in range(3):
                t0 = time.perf_counter()
                r.rewind()
                while r.next(dst):
                    pass
                print(f"  reader T={threads} pass {rep}: "
                      f"{NBYTES / (time.perf_counter() - t0) / 1e9:.2f} GB/s")
    del mm, mmf
    os.remove(path)


def main():
    print("cpu_count", os.cpu_count(), "affinity",
          len(os.sched_getaffinity(0)), "torch threads",
          torch.get_num_threads())
    print(subprocess.run(["sh", "-c", "grep -E ' /tmp | / ' /proc/mounts; "
                          "df -h /tmp . | tail -2"],
                         capture_output=True, text=True).stdout)
    with tempfile.TemporaryDirectory() as tmp:
        lib = _lib(tmp)
        for d in (tempfile.gettempdir(), os.getcwd()):
            _rates(lib, d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
