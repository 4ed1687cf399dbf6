"""Shape policies: the ladders every captured specialization draws from.

Counterpart of ``dask_ml_tpu/plans/ladders.py``, with the same rungs for
the same arguments. A CUDA graph is shape-specialized as an XLA program
is, so every path that feeds ragged work into a captured entry point
makes the same three decisions: which fixed shapes exist (the rungs),
which rung a workload takes, and how its padding is masked out. Each
policy keeps its semantics as a :class:`ShapeLadder` subclass, with the
padding and mask helpers beside the rung choice:

- :class:`GeometricLadder` (serving rows): geometric rungs CLAMPED to
  ``max_rows``: padding is paid per request, and batches taller than the
  top rung are the caller's to chunk;
- :class:`NnzLadder` (sparse staging): pure geometric rungs, NEVER
  clamped to the observed maximum, so a capacity stays a rung of the
  ladder and not a corpus's exact nnz;
- :class:`SlotRungLadder` (search cohorts): powers of two below the
  candidate count plus the full count, dropping a power within 25 % of
  the full count.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["ShapeLadder", "GeometricLadder", "NnzLadder",
           "SlotRungLadder"]


class ShapeLadder:
    """Base shape policy: a named family of captured-shape rungs.

    Subclasses implement ``rung_for`` (and usually an iterable rung
    set); the base class co-locates the padding/mask helpers so callers
    never hand-build a mask that disagrees with the rung they chose.
    """

    kind = "shape"

    def rung_for(self, n: int, **kw) -> int:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__

    # -- padding/mask co-location -----------------------------------------
    @staticmethod
    def pad_rows(X, rung: int):
        """``X`` (n, ...) zero-padded up to ``rung`` rows (a no-copy
        passthrough at exact fit). Pairs with :meth:`row_mask`."""
        X = np.asarray(X)
        n = X.shape[0]
        if n == rung:
            return X
        if n > rung:
            raise ValueError(f"{n} rows exceed the rung {rung}")
        out = np.zeros((rung,) + X.shape[1:], X.dtype)
        out[:n] = X
        return out

    @staticmethod
    def row_mask(n: int, rung: int, dtype=np.float32):
        """The validity mask matching :meth:`pad_rows`: 1.0 for the
        ``n`` real rows, 0.0 for the rung's padding tail."""
        m = np.zeros(rung, dtype)
        m[:n] = 1
        return m


class GeometricLadder(ShapeLadder):
    """The geometric sequence of padded batch heights
    (min, min*g, min*g^2, ..., max) — serving's shape policy.

    ``rung_for(n)`` returns the smallest rung >= n; callers chunk
    requests taller than the top rung (``max_rows``) first. The last
    rung CLAMPS to ``max_rows`` exactly: padding waste is paid per
    request here, so the top rung must not overshoot the configured
    maximum. Geometric (not linear) spacing is the padding/capture
    trade: with growth ``g`` the padded rows waste less than
    ``(g-1)/g`` of any batch while the rung count stays logarithmic in
    ``max/min``.
    """

    kind = "rows"

    __slots__ = ("buckets",)

    def __init__(self, min_rows=8, max_rows=1024, growth=2.0):
        if min_rows < 1:
            raise ValueError(f"min_rows must be >= 1, got {min_rows}")
        if max_rows < min_rows:
            raise ValueError(
                f"max_rows={max_rows} < min_rows={min_rows}"
            )
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        rungs = [int(min_rows)]
        while rungs[-1] < max_rows:
            nxt = max(int(math.ceil(rungs[-1] * growth)), rungs[-1] + 1)
            rungs.append(min(nxt, int(max_rows)))
        self.buckets = tuple(rungs)

    @property
    def max_rows(self) -> int:
        return self.buckets[-1]

    def __len__(self):
        return len(self.buckets)

    def __iter__(self):
        return iter(self.buckets)

    def __repr__(self):
        return f"{type(self).__name__}{self.buckets}"

    def describe(self) -> str:
        return f"{self.kind}{self.buckets}"

    def rung_for(self, n_rows: int) -> int:
        """Smallest rung >= n_rows. Raises for batches taller than the
        top rung — the caller must chunk those, padding DOWN would drop
        rows and padding up past max would mint a novel shape."""
        if n_rows > self.buckets[-1]:
            raise ValueError(
                f"batch of {n_rows} rows exceeds the top bucket "
                f"{self.buckets[-1]}; chunk before bucketing"
            )
        for b in self.buckets:
            if b >= n_rows:
                return b
        raise AssertionError("unreachable")  # pragma: no cover

    # serving's historical spelling (BucketLadder API)
    def bucket_for(self, n_rows: int) -> int:
        return self.rung_for(n_rows)

    def padding_for(self, n_rows: int) -> int:
        """Rows of padding the ladder charges a batch of ``n_rows``."""
        return self.rung_for(n_rows) - n_rows


class NnzLadder(ShapeLadder):
    """The sparse-staging nnz policy: geometric from ``min_nnz``,
    deliberately NEVER clamped to an observed maximum.

    ``rung_for(nnz, top=...)`` clips to ``top`` — callers pass the max
    RUNG any block of their plan needs (itself computed with
    ``top=0``), so the staging capacity always stays a geometric rung:
    keying a captured shape to a corpus's exact nnz would mint a
    fresh specialization per corpus (the exact failure mode the serving
    ladder's clamp is harmless against, and this one is not).
    """

    kind = "nnz"

    __slots__ = ("min_nnz", "growth")

    def __init__(self, min_nnz=128, growth=2.0):
        if min_nnz < 1:
            raise ValueError(f"min_nnz must be >= 1, got {min_nnz}")
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.min_nnz = int(min_nnz)
        self.growth = float(growth)

    def __repr__(self):
        return (f"NnzLadder(min_nnz={self.min_nnz}, "
                f"growth={self.growth})")

    def describe(self) -> str:
        return f"nnz(geometric {self.min_nnz}x{self.growth}, no clamp)"

    def rung_for(self, nnz: int, top: int = 0) -> int:
        """Smallest geometric rung >= nnz, clipped to ``top``'s own
        rung when ``top`` is given (0 = unclipped)."""
        r = self.min_nnz
        while r < nnz:
            r = int(np.ceil(r * self.growth))
        return min(r, max(top, 1)) if top else r

    def rungs_to(self, top: int) -> tuple:
        """Every rung up to (and including) ``top``'s rung — the grid a
        warmer walks."""
        out, r = [], self.min_nnz
        cap = self.rung_for(top)
        while r < cap:
            out.append(r)
            r = int(np.ceil(r * self.growth))
        out.append(cap)
        return tuple(out)

    @staticmethod
    def pad_triple(data, cols, rows, rung: int):
        """The COO-expanded triple zero-padded to ``rung`` entries —
        the sparse twin of :meth:`ShapeLadder.pad_rows` (zero values /
        zero row-ids: padding entries contribute nothing to a
        segment_sum)."""
        nnz = len(data)
        if nnz > rung:
            raise ValueError(f"{nnz} nonzeros exceed the rung {rung}")
        d = np.zeros(rung, np.float32)
        c = np.zeros(rung, np.int32)
        r = np.zeros(rung, np.int32)
        d[:nnz] = data
        c[:nnz] = cols
        r[:nnz] = rows
        return d, c, r


class SlotRungLadder(ShapeLadder):
    """The search-cohort slot-width policy: powers of two below the
    candidate count, then the full count; a power within 25% of the
    full count is dropped (warming a near-duplicate rung costs more
    than its padding ever saves). Every rung is built during a
    search's first round, so a shrinking bracket later picks its rung
    with nothing new to build."""

    kind = "slots"

    __slots__ = ()

    def __repr__(self):
        return "SlotRungLadder()"

    def describe(self) -> str:
        return "slots(pow2 + full, 25% dedup)"

    def rungs_for(self, n_slots: int) -> list:
        n_slots = max(int(n_slots), 1)
        out, r = [], 1
        while r < n_slots:
            out.append(r)
            r *= 2
        if out and out[-1] * 4 >= n_slots * 3:
            out.pop()
        out.append(n_slots)
        return out

    def rung_for(self, n_active: int, n_slots: int) -> int:
        for r in self.rungs_for(n_slots):
            if r >= n_active:
                return r
        return max(int(n_slots), 1)
