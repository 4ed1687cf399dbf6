"""Adaptive incremental hyperparameter search.

Counterpart of ``dask_ml_tpu/model_selection/_incremental.py``: a
synchronous host controller trains models one data block per
``partial_fit`` call and scores them on a held-out split. The
``additional_calls`` protocol is kept exactly: it receives ``{model_id:
[history records]}`` and returns ``{model_id: n_more_partial_fit_calls}``
(an empty or all-zero dict stops the search). SuccessiveHalving and
Hyperband run on this controller.

Execution planes of a round's batchable candidates (the SGD estimators'
batched-trial protocol):

- the streamed cohort plane (``_StreamCohortPlane``, the default for a
  host X, dense or sparse; a sparse one streams its nonzeros, the
  holdout staged as one slab): the round's requests, heterogeneous ``n_calls`` and
  cursors included, fold onto one block-step timeline, and ONE
  ``BlockStream`` pass trains them all, a model advancing only on its
  own steps (``_streamed_cohort_round``: one ``fused_sgd_many_block_grad``
  launch a step on the card); the holdout is staged once and each round
  scored with one product;
- ``config.search_stream=False``: the device-resident cohort path over
  the same blocks (``_batched_fused_calls`` per (n_calls, cursor) group,
  ``_batched_score_default``), the twin the streamed plane is held to.

Both planes cut the train split with ``fit_block_rows`` (the streamed
SGD fits' partition). A device-resident X (ShardedArray or tensor) keeps
its train split on the device as one block (the JAX package cuts one
block per data shard). Models of other packages run their
``partial_fit`` on host blocks, in a thread pool under the caller's
configuration.

Round checkpoints (``config.checkpoint_dir``): after every round the
controller state (history, per-model metadata, the models, the active
set and the adaptive hook's schedule position) is saved atomically
(``utils.checkpoint.SearchCheckpoint``; tensors ride as host numpy) in a
per-search subdirectory keyed by an identity token over the search's
class, prefix, estimator, candidates, data shape and content
fingerprint, split, budget, ``random_state`` and plane. A killed search
rerun alike resumes after its last saved round, on either plane; a
search with ``random_state=None`` draws a fresh split every run, so it
writes no checkpoint at all; a completed search clears its own.

Several processes (``parallel/distributed.py``; JAX
``_incremental.py:300-350``): model ``mid`` is owned by process
``mid % process_count()``; each round every process trains and scores
its own models (on its own card, inside ``distributed.local_section``,
on the plane it would use alone), then one ``allgather_object`` merges
the round's records, so the adaptive decisions are made alike
everywhere; a failure anywhere fails every process at that exchange. At
the end every process receives every model. Such a search needs host X
and y and a fixed ``random_state`` (every process must draw the same
split and candidates) and writes no round checkpoint.
``disable_process_distribution`` (thread-local, as in the JAX package)
runs a search on this process alone: Hyperband's brackets, striped
across processes, each run their successive halving under it.

Not ported: the per-fit log sinks (Observability).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..base import BaseEstimator, clone, to_host
from ..config import get_config, in_caller_config
from ..metrics.scorer import check_scoring
from ..parallel.sharded import ShardedArray
from ..parallel.streaming import (BlockStream, _is_sparse_source,
                                  as_row_indexable, fit_block_rows)
from ._params import ParameterGrid, ParameterSampler
from ._split import take_rows, train_test_split

_PACKAGE = __name__.split(".")[0]


def _on_device(a):
    return isinstance(a, (ShardedArray, torch.Tensor))


def _to_host(a):
    """``a`` on the host; a sparse split stays sparse (CSR)."""
    if _is_sparse_source(a):
        return as_row_indexable(a)
    return to_host(a)


def _is_port_model(m):
    return type(m).__module__.split(".")[0] == _PACKAGE


def _blocks_of(X, y, n_blocks, block_rows=None):
    """Row blocks, the unit of one partial_fit call: device gathers of a
    device-resident X, host slices of a host X, ``n_blocks`` of them or
    ``block_rows`` tall (the stream partition)."""
    n = X.n_rows if isinstance(X, ShardedArray) else int(X.shape[0])
    bs = int(block_rows) if block_rows \
        else max(int(np.ceil(n / n_blocks)), 1)
    out = []
    for i in range(0, n, bs):
        idx = np.arange(i, min(i + bs, n))
        if not idx.size:
            continue
        if _on_device(X):
            out.append((take_rows(X, idx), take_rows(y, idx)
                        if _on_device(y) else np.asarray(y)[idx]))
        else:
            out.append((X[i:i + bs], y[i:i + bs]))
    return out


def _host_model(model):
    """``model`` with its tensor attributes moved to the host (the wire
    form of the models a multi-process search exchanges); a port model
    moves its weights back to its device at its next step."""
    for k, v in list(vars(model).items()):
        if isinstance(v, torch.Tensor):
            setattr(model, k, v.detach().cpu())
    return model


def _supports_batch(model) -> bool:
    return hasattr(type(model), "_batched_partial_fit") and \
        hasattr(model, "_batch_key")


# Hyperband stripes whole brackets across processes; the successive
# halving it runs per bracket must not stripe its candidates again (the
# peers run other brackets: a nested all-gather would deadlock).
# Thread-local: virtual ranks are threads of one process, and rank A
# leaving its bracket must not re-enable distribution under rank B.
_dist_state = threading.local()


def _dist_is_disabled():
    return getattr(_dist_state, "disabled", False)


@contextlib.contextmanager
def disable_process_distribution():
    """Run the searches started on this thread on this process alone
    (the JAX package's switch): the controller owns every candidate, and
    every fit runs in a one-process world (``distributed.local_section``)."""
    from ..parallel.distributed import local_section

    prev = getattr(_dist_state, "disabled", False)
    _dist_state.disabled = True
    try:
        with local_section():
            yield
    finally:
        _dist_state.disabled = prev


class _StreamCohortPlane:
    """The streamed data plane of the adaptive searches' cohort rounds.

    It owns the block partition (``fit_block_rows`` of the train split,
    the streamed SGD fits' formula), one ``BlockStream`` per cohort batch
    key (the stream stages the key's encoded targets) reused by every
    round, one staged holdout per key, and ``n_slots``, the search's
    candidate count, the height of the stacked cohort weights. Every
    host X, dense or sparse, engages it; the JAX package's probe of its superblock
    scans has no counterpart."""

    def __init__(self, X_train, y_train, X_test, y_test, n_slots):
        self.X, self.y = X_train, y_train
        self.X_test, self.y_test = X_test, y_test
        self.n_slots = int(n_slots)
        n = int(X_train.shape[0])
        self.block_rows = int(fit_block_rows(X_train))
        self.n_blocks = max(-(-n // self.block_rows), 1)
        self._streams = {}
        self._holdouts = {}
        self.stats = {"rounds": 0, "dispatches": 0, "shards": 1,
                      "sparse": False, "fused": False, "fused_reason": None}

    @staticmethod
    def eligible(estimator, X_train):
        """Host-resident dense X and an estimator with the streamed
        cohort protocol."""
        return (hasattr(type(estimator), "_streamed_cohort_round")
                and not _on_device(X_train))

    def stream_for(self, key, model):
        stream = self._streams.get(key)
        if stream is None:
            y_enc = np.asarray(model._encode_y(np.asarray(self.y)),
                               np.float32)
            X = self.X if _is_sparse_source(self.X) \
                else np.asanyarray(self.X)
            stream = BlockStream((X, y_enc), block_rows=self.block_rows,
                                 shuffle=False)
            self._streams[key] = stream
        return stream

    def holdout_for(self, key, cls, model):
        holdout = self._holdouts.get(key)
        if holdout is None:
            holdout = self._holdouts[key] = cls._cohort_holdout(
                self.X_test, self.y_test, model)
        return holdout

    def note_round(self, info):
        """Fold one round's record into the plane's stats
        (``search.metadata_["stream"]``)."""
        self.stats["rounds"] += 1
        self.stats["dispatches"] += int(info.get("dispatches", 0))
        self.stats["shards"] = int(info.get("shards", 1))
        self.stats["sparse"] = bool(info.get("sparse", False))
        self.stats["fused"] = bool(info.get("fused", False))
        self.stats["fused_reason"] = info.get("fused_reason")

    def snapshot(self):
        return {"streamed": True, "n_blocks": int(self.n_blocks),
                "block_rows": int(self.block_rows),
                "n_slots": int(self.n_slots), **self.stats}


def fit(model_factory, params_list, train_blocks, X_test, y_test, scorer,
        additional_calls, fit_params=None, patience=False, tol=1e-3,
        max_iter=None, scoring_is_default=False, stream_plane=None,
        checkpoint=None, ckpt_token=None, hook_state=None):
    """The controller (ref: _incremental.py::_fit). Returns (info,
    models, meta, history).

    ``checkpoint`` (a ``SearchCheckpoint``) saves the controller state
    after every round; a saved state whose token is ``ckpt_token``
    resumes the search after its last round. ``hook_state`` is the
    (get, set) pair of the adaptive hook's schedule position."""
    from ..parallel import distributed as dist

    fit_params = fit_params or {}
    models, meta, info, history = {}, {}, {}, []
    start = time.time()
    n_blocks = len(train_blocks)
    round_idx, active = 0, None
    # several processes: model mid is owned by process mid % n_proc
    n_proc = 1 if _dist_is_disabled() else dist.process_count()
    pid = dist.process_index() if n_proc > 1 else 0
    if n_proc > 1:
        # a process's share of the models is not a resumable state
        checkpoint = ckpt_token = None

    def _owned(mid):
        return n_proc == 1 or mid % n_proc == pid

    pending = []  # this round's records, merged at the round's exchange
    restored = checkpoint.load() if checkpoint is not None else None
    if restored is not None and ckpt_token is not None \
            and restored.get("token") == ckpt_token:
        round_idx = restored["round"]
        history, meta, models = (restored["history"], restored["meta"],
                                 restored["models"])
        active = set(restored["active"])
        start = time.time() - restored.get("elapsed", 0.0)
        if hook_state is not None and restored.get("hook") is not None:
            hook_state[1](restored["hook"])
        info = {mid: [r for r in history if r["model_id"] == mid]
                for mid in models}
    else:
        restored = None
        for mid, params in enumerate(params_list):
            models[mid] = model_factory(params)
            meta[mid] = {"model_id": mid, "params": params,
                         "partial_fit_calls": 0, "score": None,
                         "block_cursor": 0}
            info[mid] = []

    def save_round():
        if checkpoint is None:
            return
        checkpoint.save_round(round_idx, history, meta, models, extra={
            "token": ckpt_token,
            "active": sorted(active if active is not None else models),
            "hook": hook_state[0]() if hook_state is not None else None,
            "elapsed": time.time() - start,
        })

    def record_scores(mids, scores, fit_time, score_time,
                      executor="sequential"):
        for mid, score in zip(mids, scores):
            m = meta[mid]
            m["score"] = float(score)
            record = {
                "model_id": mid, "params": m["params"],
                "partial_fit_calls": m["partial_fit_calls"],
                "partial_fit_time": fit_time, "score": float(score),
                "score_time": score_time,
                "elapsed_wall_time": time.time() - start,
                "batch_size": len(mids), "executor": executor,
                "thread": threading.get_ident(), "owner": pid,
            }
            if n_proc > 1:
                pending.append(record)
            else:
                history.append(record)
                info[mid].append(record)

    def sync_round(exc=None):
        """The round's exchange: every process's records (and its models'
        cursors and scores) to every process, in (calls, model) order;
        a failure anywhere fails every process here."""
        if n_proc == 1:
            if exc is not None:
                raise exc
            return
        payload = {
            "records": list(pending),
            "meta": {mid: {k: meta[mid][k] for k in
                           ("partial_fit_calls", "block_cursor", "score")}
                     for mid in meta if _owned(mid)},
            "error": None if exc is None else repr(exc),
        }
        pending.clear()
        parts = dist.allgather_object(payload)
        if exc is not None:
            raise exc
        bad = [p["error"] for p in parts if p["error"] is not None]
        if bad:
            raise RuntimeError(f"peer process failed during distributed "
                               f"adaptive search: {bad}")
        merged = [r for p in parts for r in p["records"]]
        merged.sort(key=lambda r: (r["partial_fit_calls"], r["model_id"]))
        for rec in merged:
            history.append(rec)
            info[rec["model_id"]].append(rec)
        for p in parts:
            for mid, m in p["meta"].items():
                meta[mid].update(m)

    def train_one(mid, n_calls, executor="sequential"):
        m = meta[mid]
        model = models[mid]
        t0 = time.time()
        for _ in range(n_calls):
            Xb, yb = train_blocks[m["block_cursor"] % n_blocks]
            model.partial_fit(Xb, yb, **fit_params)
            m["block_cursor"] += 1
            m["partial_fit_calls"] += 1
        fit_time = time.time() - t0
        t0 = time.time()
        score = scorer(model, X_test, y_test)
        record_scores([mid], [score], fit_time, time.time() - t0,
                      executor=executor)

    def train_cohort(mids, n_calls):
        """Advance a cohort sharing a cursor: its n_calls block steps in
        one ``_batched_fused_calls`` (one launch a step; a block the
        steps revisit is placed once)."""
        cohort = [models[mid] for mid in mids]
        cls = type(cohort[0])
        t0 = time.time()
        cursor = meta[mids[0]]["block_cursor"]
        idxs = [(cursor + i) % n_blocks for i in range(n_calls)]
        uniq = sorted(set(idxs))
        pos = {j: k for k, j in enumerate(uniq)}
        cls._batched_fused_calls(cohort, [train_blocks[j] for j in uniq],
                                 order=[pos[j] for j in idxs])
        for mid in mids:
            meta[mid]["block_cursor"] += n_calls
            meta[mid]["partial_fit_calls"] += n_calls
        cls._batch_publish(cohort, train_blocks[0][0].shape[1])
        fit_time = time.time() - t0
        t0 = time.time()
        if scoring_is_default and hasattr(cls, "_batched_score_default"):
            scores = cls._batched_score_default(cohort, X_test, y_test)
        else:
            scores = [scorer(m, X_test, y_test) for m in cohort]
        score_time = time.time() - t0
        # each model's share of the cohort's time: summing history_
        # timings gives the wall clock, batch_size the cohort's total
        record_scores(mids, scores, fit_time / len(mids),
                      score_time / len(mids), executor="vmapped")

    def train_cohort_streamed(key, ent):
        """Advance every batchable candidate sharing ``key`` through ONE
        pass of the key's stream: the round's requests fold onto one
        block-step timeline (two models at the same absolute call index
        share the step) and each model trains on exactly the blocks its
        own partial_fit loop would."""
        mids = [mid for mid, _ in ent]
        cohort = [models[mid] for mid in mids]
        cls = type(cohort[0])
        t0 = time.time()
        stream = stream_plane.stream_for(key, cohort[0])
        nb = stream_plane.n_blocks
        starts = {mid: meta[mid]["block_cursor"] for mid in mids}
        timeline = sorted({starts[mid] + j for mid, nc in ent
                           for j in range(nc)})
        step_of = {t: s for s, t in enumerate(timeline)}
        order = np.asarray([t % nb for t in timeline], np.int64)
        act = np.zeros((len(timeline), len(mids)), np.float32)
        for i, (mid, nc) in enumerate(ent):
            for j in range(nc):
                act[step_of[starts[mid] + j], i] = 1.0
        info_round = cls._streamed_cohort_round(
            cohort, stream, order, act, stream_plane.n_slots,
            warm=stream_plane.stats["rounds"] == 0)
        for mid, nc in ent:
            meta[mid]["block_cursor"] += nc
            meta[mid]["partial_fit_calls"] += nc
        fit_time = time.time() - t0
        t0 = time.time()
        if scoring_is_default and hasattr(cls, "_cohort_holdout_scores"):
            holdout = stream_plane.holdout_for(key, cls, cohort[0])
            scores = cls._cohort_holdout_scores(cohort, holdout,
                                                stream_plane.n_slots)
        else:
            scores = [scorer(m, X_test, y_test) for m in cohort]
        score_time = time.time() - t0
        stream_plane.note_round(info_round)
        record_scores(mids, scores, fit_time / len(mids),
                      score_time / len(mids), executor="streamed")

    def run_round(requests):
        """One round: this process's share of ``requests`` (all of them
        for one process) in a one-process world, then the exchange."""
        mine = {mid: c for mid, c in requests.items() if _owned(mid)}
        try:
            with dist.local_section():
                run_requests(mine)
        except Exception as e:
            sync_round(e)
            raise
        sync_round()

    def run_requests(requests):
        """Execute {mid: n_calls > 0}: everything batchable in cohorts,
        grouped by (batch key, n_calls, block cursor)."""
        solo, groups = [], {}
        for mid, n_calls in requests.items():
            model = models[mid]
            key = None
            if _supports_batch(model):
                model._batch_prepare(fit_params)
                key = model._batch_key()
            if key is None:
                solo.append((mid, n_calls))
            else:
                gk = (key, n_calls, meta[mid]["block_cursor"] % n_blocks)
                groups.setdefault(gk, []).append(mid)
        # models of this package run in order (they share the card);
        # other packages' host models overlap in threads
        host_solo = [(m, n) for m, n in solo if not _is_port_model(models[m])]
        for mid, n_calls in solo:
            if _is_port_model(models[mid]):
                train_one(mid, n_calls)
        if len(host_solo) > 1:
            task = in_caller_config(train_one)
            with ThreadPoolExecutor(
                    max_workers=min(8, len(host_solo))) as pool:
                futures = [pool.submit(task, mid, n_calls, "threads")
                           for mid, n_calls in host_solo]
                for f in futures:
                    f.result()
        else:
            for mid, n_calls in host_solo:
                train_one(mid, n_calls)
        if stream_plane is not None and groups:
            # every batchable group of one key rides the same pass
            by_key = {}
            for (key, n_calls, _cursor), mids in groups.items():
                by_key.setdefault(key, []).extend((mid, n_calls)
                                                  for mid in mids)
            for key, ent in sorted(by_key.items(),
                                   key=lambda kv: min(m for m, _ in kv[1])):
                train_cohort_streamed(key, sorted(ent))
            return
        for (key, n_calls, _cursor), mids in sorted(
                groups.items(), key=lambda kv: kv[1][0]):
            if len(mids) == 1 and n_calls == 1:
                train_one(mids[0], n_calls)
            else:
                train_cohort(mids, n_calls)

    # first round: one call each (done already in a resumed search)
    if restored is None:
        run_round({mid: 1 for mid in models})
        round_idx = 1
        active = set(models)
        save_round()
    while active:
        instructions = additional_calls({mid: info[mid] for mid in active})
        instructions = {mid: c for mid, c in instructions.items()
                        if mid in active}
        active = set(instructions)
        if not instructions or all(c == 0 for c in instructions.values()):
            break
        requests = {}
        for mid, n_calls in instructions.items():
            if n_calls <= 0:
                continue
            if patience and len(info[mid]) > patience:
                recent = [r["score"] for r in info[mid][-patience:]]
                if max(recent) < info[mid][-patience - 1]["score"] + tol:
                    # plateaued: retired, so the hook stops asking for it
                    active.discard(mid)
                    continue
            if max_iter is not None and (
                    meta[mid]["partial_fit_calls"] + n_calls > max_iter):
                n_calls = max_iter - meta[mid]["partial_fit_calls"]
                if n_calls <= 0:
                    active.discard(mid)
                    continue
            requests[mid] = n_calls
        if not requests:
            break  # every requested model was retired
        run_round(requests)
        round_idx += 1
        save_round()
    if checkpoint is not None:
        checkpoint.clear()  # completed: never resume into a new search
    if n_proc > 1:
        # every process receives every trained model (weights and
        # parameters), so best_estimator_ works alike everywhere
        for part in dist.allgather_object(
                {mid: _host_model(models[mid]) for mid in models
                 if _owned(mid)}):
            models.update(part)
    return info, models, meta, history


class BaseIncrementalSearchCV(BaseEstimator):
    """Shared plumbing of the adaptive searches."""

    def __init__(self, estimator, parameters, n_initial_parameters=10,
                 test_size=None, patience=False, tol=1e-3, max_iter=100,
                 random_state=None, scoring=None, verbose=False, prefix=""):
        self.estimator = estimator
        self.parameters = parameters
        self.n_initial_parameters = n_initial_parameters
        self.test_size = test_size
        self.patience = patience
        self.tol = tol
        self.max_iter = max_iter
        self.random_state = random_state
        self.scoring = scoring
        self.verbose = verbose
        self.prefix = prefix

    # -- hooks overridden by subclasses -----------------------------------
    def _n_initial(self):
        return self.n_initial_parameters

    def _additional_calls(self, info):
        raise NotImplementedError

    def _reset_hook(self):
        """Reset the adaptive schedule at the start of each fit."""

    def _hook_state(self):
        """The schedule position a round checkpoint carries."""
        return {}

    def _set_hook_state(self, state):
        for k, v in state.items():
            setattr(self, k, v)

    def _checkpoint(self, X, y, params_list, n_blocks, test_size):
        """(SearchCheckpoint, token) of this search under
        ``config.checkpoint_dir``, or (None, None): no directory, or
        ``random_state=None`` (a fresh split every run cannot resume)."""
        ckpt_dir = get_config().checkpoint_dir
        if not ckpt_dir or self.random_state is None:
            return None, None
        from ..utils.checkpoint import SearchCheckpoint
        from ..utils.validation import data_fingerprint
        from ._normalize import _token_piece, estimator_token

        shape = X.shape if hasattr(X, "shape") else np.shape(X)
        token = hashlib.sha1("|".join([
            type(self).__name__, self.prefix,
            estimator_token(self.estimator), _token_piece(params_list),
            str(tuple(shape)), data_fingerprint(X), data_fingerprint(y),
            str(n_blocks), str(self.max_iter), str(self.patience),
            str(self.tol), str(self.random_state), str(test_size),
            str(bool(get_config().search_stream)),
        ]).encode()).hexdigest()
        # one subdirectory per search: another search under the same
        # directory neither overwrites nor clears this one's state
        sub = "-".join(p for p in (type(self).__name__, self.prefix,
                                   token[:12]) if p)
        return SearchCheckpoint(os.path.join(ckpt_dir, sub)), token

    def _sample_params(self, n):
        return list(ParameterSampler(self.parameters, n,
                                     random_state=self.random_state))

    def fit(self, X, y=None, **fit_params):
        from ..parallel import distributed as dist

        if dist.process_count() > 1 and not _dist_is_disabled():
            if _on_device(X) or _on_device(y):
                raise ValueError(
                    "a multi-process adaptive search requires host-resident "
                    "X/y (each process loads its copy and trains a disjoint "
                    "share of the candidates)")
            if self.random_state is None:
                raise ValueError(
                    "a multi-process adaptive search requires a fixed "
                    "random_state: every process must draw the identical "
                    "train/test split and candidates")
            self._dist_stats = (dist.process_index(), dist.process_count())
        test_size = 0.15 if self.test_size is None else self.test_size
        # the split's seed apart from the sampling seed: Hyperband's
        # bracket searches sample with random_state + s but split like
        # the single-process search
        split_seed = getattr(self, "_split_random_state", self.random_state)
        X_train, X_test, y_train, y_test = train_test_split(
            X, y, test_size=test_size, random_state=split_seed)
        scorer_raw = check_scoring(self.estimator, self.scoring)
        est_device = _supports_batch(self.estimator)
        if not est_device:
            # models of other packages (and host-only partial_fit) train
            # on host blocks
            X_train, y_train = _to_host(X_train), _to_host(y_train)
            X_test, y_test = _to_host(X_test), _to_host(y_test)
        params_list = self._sample_params(self._n_initial())
        stream_plane = None
        if _StreamCohortPlane.eligible(self.estimator, X_train):
            plane = _StreamCohortPlane(X_train, y_train, X_test, y_test,
                                       n_slots=len(params_list))
            if get_config().search_stream:
                stream_plane = plane
            blocks = _blocks_of(X_train, y_train, plane.n_blocks,
                                block_rows=plane.block_rows)
        else:
            # one block per data shard, as in the JAX package: one on
            # one device
            blocks = _blocks_of(X_train, y_train, 1)

        def factory(params):
            return clone(self.estimator).set_params(**params)

        self._reset_hook()
        checkpoint, token = self._checkpoint(X, y, params_list, len(blocks),
                                             test_size)
        info, models, meta, history = fit(
            factory, params_list, blocks, X_test, y_test, scorer_raw,
            self._additional_calls, fit_params=fit_params,
            patience=self.patience, tol=self.tol, max_iter=self.max_iter,
            scoring_is_default=self.scoring is None,
            stream_plane=stream_plane, checkpoint=checkpoint,
            ckpt_token=token,
            hook_state=(self._hook_state, self._set_hook_state))

        self.history_ = history
        self.model_history_ = info
        n_models = len(params_list)
        scores = np.array([info[mid][-1]["score"] if info[mid] else np.nan
                           for mid in range(n_models)])
        calls = np.array([meta[mid]["partial_fit_calls"]
                          for mid in range(n_models)])
        order = np.argsort(-scores, kind="stable")
        ranks = np.empty(n_models, np.int32)
        ranks[order] = np.arange(1, n_models + 1)
        results = {
            "params": params_list, "test_score": scores,
            "mean_test_score": scores, "rank_test_score": ranks,
            "model_id": np.arange(n_models), "partial_fit_calls": calls,
        }
        for key in sorted({k for p in params_list for k in p}):
            results[f"param_{key}"] = np.ma.masked_all(n_models,
                                                       dtype=object)
            for ci, p in enumerate(params_list):
                if key in p:
                    results[f"param_{key}"][ci] = p[key]
        self.cv_results_ = results
        self.best_index_ = int(np.nanargmax(scores))
        self.best_score_ = float(scores[self.best_index_])
        self.best_params_ = params_list[self.best_index_]
        self.best_estimator_ = models[self.best_index_]
        self.n_splits_ = 1
        self.multimetric_ = False
        self.scorer_ = scorer_raw
        self.metadata_ = {
            "n_models": n_models,
            "partial_fit_calls": int(calls.sum()),
            # which plane the cohort rounds rode and how many launches
            # the search made there
            "stream": (stream_plane.snapshot() if stream_plane is not None
                       else {"streamed": False}),
        }
        return self

    # -- post-fit delegation ----------------------------------------------
    def predict(self, X):
        return self.best_estimator_.predict(X)

    def predict_proba(self, X):
        return self.best_estimator_.predict_proba(X)

    def decision_function(self, X):
        return self.best_estimator_.decision_function(X)

    def score(self, X, y=None):
        return self.scorer_(self.best_estimator_, X, y)

    @property
    def classes_(self):
        return self.best_estimator_.classes_


class IncrementalSearchCV(BaseIncrementalSearchCV):
    """Ref: dask_ml/model_selection/_incremental.py::IncrementalSearchCV:
    after scoring event k keep the top ``n_initial / (1 + decay_rate *
    k)`` models and give each one more call (``decay_rate=None`` keeps
    all models to max_iter)."""

    def __init__(self, estimator, parameters, n_initial_parameters=10,
                 decay_rate=1.0, test_size=None, patience=False, tol=1e-3,
                 fits_per_score=1, max_iter=100, random_state=None,
                 scoring=None, verbose=False, prefix=""):
        super().__init__(estimator, parameters,
                         n_initial_parameters=n_initial_parameters,
                         test_size=test_size, patience=patience, tol=tol,
                         max_iter=max_iter, random_state=random_state,
                         scoring=scoring, verbose=verbose, prefix=prefix)
        self.decay_rate = decay_rate
        self.fits_per_score = fits_per_score
        self._step = 0

    def _reset_hook(self):
        self._step = 0

    def _hook_state(self):
        return {"_step": self._step}

    def _n_initial(self):
        if self.n_initial_parameters == "grid":
            return len(ParameterGrid(self.parameters))
        return self.n_initial_parameters

    def _sample_params(self, n):
        if self.n_initial_parameters == "grid":
            return list(ParameterGrid(self.parameters))
        return super()._sample_params(n)

    def _additional_calls(self, info):
        self._step += 1
        scores = {mid: recs[-1]["score"] for mid, recs in info.items()}
        calls = {mid: recs[-1]["partial_fit_calls"]
                 for mid, recs in info.items()}
        if self.decay_rate is None:
            keep = list(scores)
        else:
            n_keep = max(1, int(self._n_initial()
                                / (1 + self.decay_rate * self._step)))
            keep = sorted(scores, key=scores.get, reverse=True)[:n_keep]
        out = {mid: 0 if calls[mid] >= self.max_iter else self.fits_per_score
               for mid in keep}
        if all(v == 0 for v in out.values()):
            return {mid: 0 for mid in out}
        return out


class InverseDecaySearchCV(IncrementalSearchCV):
    """The name later dask-ml versions give IncrementalSearchCV."""
