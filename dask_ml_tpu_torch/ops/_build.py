"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``_build/`` beside this package (git-ignored) and loaded with
``ctypes``. The file name carries a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt
and a stale library is never loaded. Several
sources build in parallel, one ``nvcc`` each. A failed build raises with
the compiler's output; nothing falls back.

``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` and
``/usr/local/cuda/bin``.
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


def _target(name: str) -> str:
    """The library's path; its name hashes the source, every header of
    csrc/ (a source may include any) and the flags."""
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            h.update(src.read())
    h.update(" ".join(NVCC_FLAGS).encode())
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
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, n + ".cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        with open(targets[n] + ".log", "w") as f:
            f.write(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on csrc/{n}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, targets[n])  # atomic: readers never see half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def build_log(name: str) -> str:
    """What nvcc (with ``-Xptxas -v``) printed when it built ``name``."""
    with open(_target(name) + ".log") as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build((name,))[name])
        return lib
