"""Pass-granular checkpoint and resume of the streamed fits.

Counterpart of ``dask_ml_tpu/reliability/stream_ckpt.py``.
:class:`StreamCheckpoint` is one fit's checkpoint slot:

- **an identity token**: a SHA-1 over the fit's kind, its
  hyperparameters and partition, and a content fingerprint of its data
  (``utils.validation.data_fingerprint``); a checkpoint written by
  another fit (other data, knobs or shapes) is ignored, never resumed;
- **pass granularity**: a consumer saves its host state after a pass
  (``config.stream_checkpoint_every`` thins the cadence) through
  ``utils.checkpoint``'s atomic writer, so a kill mid-save leaves the
  previous checkpoint intact;
- **cleared on completion**, so a finished fit never resumes into a new
  one.

Knobs: ``config.stream_checkpoint_path`` ("" = off) and
``config.stream_checkpoint_every``. Slots are namespaced by kind
(``"glm"``, ``"sgd"``, ``"kmeans"``, ``"incremental"``) under the path.
Under a multi-process runtime or in a virtual world the checkpoint is
refused, as in the JAX package (resume would have to be a collective
decision, and virtual ranks share one process's paths): the fit runs
uncheckpointed, with a ``RuntimeWarning`` saying so.
"""

from __future__ import annotations

import hashlib
import os
import shutil

import numpy as np

__all__ = ["StreamCheckpoint", "fit_token", "stream_checkpoint"]

_TOKEN_BYTES = 40  # a sha1 hex digest


class StreamCheckpoint:
    """One fit's checkpoint slot: a directory holding its host state
    under an identity token."""

    def __init__(self, path, token: str, every: int = 1):
        self.path = os.path.abspath(path)
        self.token = np.frombuffer(
            token.encode()[:_TOKEN_BYTES].ljust(_TOKEN_BYTES), np.uint8)
        self.every = max(int(every), 1)

    def due(self, pass_no: int) -> bool:
        """Save after this pass? (every N-th, counting from 1)."""
        return pass_no % self.every == 0

    def restore(self):
        """The saved state (a dict of numpy values) when a checkpoint with
        a matching token exists, else None: a foreign, corrupt or absent
        checkpoint means start fresh, never an error."""
        from ..utils import checkpoint as ckpt

        if not ckpt.checkpoint_exists(self.path):
            return None
        state = ckpt.restore_pytree(self.path)
        if state is None:
            return None
        tok = np.asarray(state.get("token", ()))
        if tok.shape != self.token.shape or not np.array_equal(tok,
                                                               self.token):
            return None
        return {k: v for k, v in state.items() if k != "token"}

    def save(self, **state) -> None:
        """Persist ``state`` (numpy values; None entries are left out)
        under the token, atomically."""
        from ..observability._counters import record_stream_checkpoint
        from ..utils import checkpoint as ckpt

        tree = {"token": self.token}
        for k, v in state.items():
            if v is not None:
                tree[k] = np.asarray(v)
        ckpt.save_pytree(self.path, tree)
        record_stream_checkpoint()

    def clear(self) -> None:
        """Remove the checkpoint (on successful completion)."""
        for suffix in ("", ".old", ".tmp"):
            shutil.rmtree(self.path + suffix, ignore_errors=True)


def fit_token(kind, token_parts, arrays=()) -> str:
    """The identity token: the fit kind, the repr of each hyperparameter
    part, and a content fingerprint of every data array."""
    from ..utils.validation import data_fingerprint

    parts = [str(kind)] + [repr(p) for p in token_parts]
    for a in arrays:
        parts.append(data_fingerprint(a))
    return hashlib.sha1("|".join(parts).encode()).hexdigest()


def stream_checkpoint(kind, token_parts, arrays=()):
    """A :class:`StreamCheckpoint` for one streamed fit of ``kind``, or
    None when ``config.stream_checkpoint_path`` is unset or refused
    (several processes, or a virtual world)."""
    from ..config import get_config

    cfg = get_config()
    if not cfg.stream_checkpoint_path:
        return None
    from ..parallel import distributed as dist

    if dist.process_count() > 1 or dist.in_virtual_world():
        import warnings

        warnings.warn(
            f"stream_checkpoint_path is set but a {kind!r} fit under a "
            "multi-process or virtual-world runtime writes no checkpoint "
            "(resume must be a collective decision); the fit runs "
            "uncheckpointed", RuntimeWarning)
        return None
    path = os.path.join(cfg.stream_checkpoint_path, str(kind))
    return StreamCheckpoint(path, fit_token(kind, token_parts, arrays),
                            every=cfg.stream_checkpoint_every)


def restore_counted(ckpt):
    """``ckpt.restore()`` (None without a checkpoint), counting a resume
    in ``stream_resumes`` when a state came back."""
    if ckpt is None:
        return None
    st = ckpt.restore()
    if st is not None:
        from ..observability._counters import record_stream_checkpoint

        record_stream_checkpoint(resume=True)
    return st
