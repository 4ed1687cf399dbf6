"""Build and load the port's CUDA kernels and its host libraries.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``_build/`` beside this package (git-ignored) and loaded with
``ctypes``. The host libraries ``csrc/<name>.cpp`` (the native block
reader and the CSV loader of ``io/native.py``, the text hashing of
``feature_extraction/text.py``) build the same way with
the host C++ compiler, so they build on a machine without a card too.
The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``, for a ``.cu``) and the flags, so an edited source is
rebuilt and a stale library is never loaded. Several sources build in
parallel, one compiler each. A failed build raises with the compiler's
output; nothing falls back.

``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` and
``/usr/local/cuda/bin``; the host compiler is ``$CXX``, else ``c++`` or
``g++`` on ``PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("glm_value_grad", "lloyd", "glm_value_grad_hess",
           "glm_multi_value_grad")
HOST_SOURCES = ("block_reader", "fast_loader", "text_hash")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def cxx_path() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler ($CXX, c++, g++ on PATH): the port's host "
        "libraries are built from source at first use"
    )


def _source(name: str) -> str:
    return name + (".cpp" if name in HOST_SOURCES else ".cu")


def _command(name: str, out: str) -> list[str]:
    src = os.path.join(CSRC_DIR, _source(name))
    if name in HOST_SOURCES:
        return [cxx_path(), *CXX_FLAGS, "-o", out, src]
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, src]


def _target(name: str) -> str:
    """The library's path; its name hashes the source, for a ``.cu``
    every header of csrc/ (a source may include any), and the flags."""
    h = hashlib.sha1()
    files = [_source(name)]
    flags = CXX_FLAGS
    if name not in HOST_SOURCES:
        files += sorted(f for f in os.listdir(CSRC_DIR)
                        if f.endswith(".cuh"))
        flags = NVCC_FLAGS
    for f in files:
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            h.update(src.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=SOURCES) -> dict[str, str]:
    """Compile every source in ``names`` whose library is missing, all at
    once, and return {name: path of its library}. Raises on a failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, so in targets.items():
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[n] = (subprocess.Popen(_command(n, tmp),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        with open(targets[n] + ".log", "w") as f:
            f.write(out)
        if proc.returncode != 0:
            errors.append(f"{os.path.basename(proc.args[0])} failed on "
                          f"csrc/{_source(n)} "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, targets[n])  # atomic: readers never see half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def build_log(name: str) -> str:
    """What the compiler printed when it built ``name`` (nvcc with
    ``-Xptxas -v`` for a kernel)."""
    with open(_target(name) + ".log") as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built if
    missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build((name,))[name])
        return lib
