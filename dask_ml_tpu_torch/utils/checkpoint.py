"""Checkpoint / resume: the atomic writers behind every checkpoint of the
port.

Counterpart of ``dask_ml_tpu/utils/checkpoint.py``. A killed fit
restarts from its last checkpoint: iteration granularity for the
solvers, pass granularity for the streamed fits, round granularity for
the adaptive searches.

State (``save_pytree``) is a flat dict of host numpy arrays, Python
ints and floats, written with ``np.savez`` into ``STATE_FILE`` inside a
checkpoint directory; the JAX package's orbax format is not read or
written. The state is host data, so a checkpoint written by a fit on
the card restores on the CPU and the other way round. Host objects
(``save_host``: the searches' controller state and models) are pickled,
with every torch tensor in them carried as host numpy and rebuilt on
``config.device`` at restore.

The atomic contract, for both writers: the new state lands in a ``.tmp``
sibling and is fsynced; the live checkpoint retires to ``.old``; one
rename publishes the new one, and only then is ``.old`` removed. At
every kill point either the old or the new state restores
(``checkpoint_exists`` and ``restore_pytree`` fall back to ``.old`` in
the crash window).
"""

from __future__ import annotations

import os
import pickle
import shutil

import numpy as np

# the one file of a checkpoint directory of this package: a directory
# without it (an orbax checkpoint of the JAX package, a partial write) is
# not a checkpoint here
STATE_FILE = "dask_ml_tpu_torch_state.npz"


def _fsync_tree(root):
    """Best-effort fsync of every file and directory under ``root``, so
    the rename below publishes durable bytes."""
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames + [None]:
            target = dirpath if name is None else os.path.join(dirpath, name)
            try:
                fd = os.open(target, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
            except OSError:
                pass


def checkpoint_exists(path) -> bool:
    """Is there a checkpoint at ``path``, or at ``path + '.old'`` (a kill
    between retiring the old checkpoint and publishing the new one)?"""
    path = os.path.abspath(path)
    return os.path.exists(path) or os.path.exists(path + ".old")


def _host_value(v):
    if isinstance(v, (bool, int, float, np.number, np.ndarray)):
        return np.asarray(v)
    if hasattr(v, "detach"):  # a tensor: its host copy
        return _tensor_host(v)[0]
    raise TypeError(f"a checkpoint holds numpy arrays, ints and floats; "
                    f"got {type(v).__name__}")


def save_pytree(path, tree):
    """Save the flat dict ``tree`` (str -> numpy array, int or float)
    atomically at ``path`` (a directory)."""
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    arrays = {str(k): _host_value(v) for k, v in tree.items()}
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    _fsync_tree(tmp)
    if os.path.exists(path):
        # retire the live checkpoint (replacing a stale .old)
        shutil.rmtree(old, ignore_errors=True)
        os.rename(path, old)
    # else a previous crash may have left the only good state at .old: it
    # stays until the new checkpoint has published
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _load(p):
    """The state dict of the checkpoint directory ``p``, or None when it
    holds none of this package's (absent, foreign, truncated)."""
    f = os.path.join(p, STATE_FILE)
    if not os.path.isfile(f):
        return None
    try:
        with np.load(f, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception:
        return None


def restore_pytree(path):
    """The flat dict saved at ``path`` (0-d arrays for scalars), falling
    back to ``path + '.old'``; None when neither holds a readable state
    of this package. Never raises for a foreign or corrupt directory, so
    a fit given one starts fresh."""
    path = os.path.abspath(path)
    state = _load(path)
    if state is None and os.path.isdir(path + ".old"):
        state = _load(path + ".old")
    return state


# -- host objects ------------------------------------------------------------

def _tensor_host(t):
    """(numpy copy, dtype name) of a tensor; bfloat16 rides as its raw
    16-bit pattern, which numpy has no type for."""
    t = t.detach().cpu()
    name = str(t.dtype).replace("torch.", "")
    if name == "bfloat16":
        import torch

        return t.view(torch.int16).numpy().copy(), name
    return t.numpy().copy(), name


def _tensor_from_host(arr, dtype_name):
    """A tensor rebuilt from ``_tensor_host`` on ``config.device``."""
    import torch

    from ..config import resolve_device

    t = torch.from_numpy(np.array(arr))
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(resolve_device())


class _HostPickler(pickle.Pickler):
    """Pickles torch tensors as host numpy: a checkpoint written on the
    card restores on any device."""

    def reducer_override(self, obj):
        if type(obj).__module__.startswith("torch") and hasattr(
                obj, "detach") and hasattr(obj, "dtype"):
            return _tensor_from_host, _tensor_host(obj)
        return NotImplemented


def _dump(obj, f):
    _HostPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)


def save_host(path, obj):
    """Pickle ``obj`` atomically at ``path``: a temp sibling, flush and
    fsync, then one rename. A kill mid-save leaves the previous file
    intact."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            _dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def restore_host(path):
    with open(path, "rb") as f:
        return pickle.load(f)


class SearchCheckpoint:
    """Controller state of an adaptive search: history, per-model
    metadata and the models, written every round so a killed search
    resumes at round granularity."""

    def __init__(self, directory):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name):
        return os.path.join(self.directory, name)

    def save_round(self, round_idx, history, meta, models, extra=None):
        state = {"round": round_idx, "history": history, "meta": meta,
                 "models": models}
        if extra:
            state.update(extra)
        save_host(self._path("controller.pkl"), state)

    def load(self):
        p = self._path("controller.pkl")
        if not os.path.exists(p):
            return None
        try:
            return restore_host(p)
        except Exception:
            return None  # unreadable: the search starts fresh

    def clear(self):
        """Remove the controller state (on completion, so a finished
        search never resumes into a new one), and the directory when
        nothing else is in it."""
        p = self._path("controller.pkl")
        if os.path.exists(p):
            os.remove(p)
        try:
            os.rmdir(self.directory)
        except OSError:
            pass
