"""Classification metrics over host arrays, tensors or ShardedArrays.

Counterpart of ``dask_ml_tpu/metrics/classification.py``: the same
functions, arguments and degenerate-input rules. Each metric reduces
with torch ops on the device of its data (a ShardedArray or tensor
keeps its device; host arrays reduce on the CPU) and returns host
floats or numpy arrays. Sums run in float64, so counts stay exact at
any row count and the JAX package's chunked float32 counts have no
counterpart; the rank statistics tie scores at float32, as the JAX
package's sort does.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..parallel.sharded import ShardedArray


class UndefinedMetricWarning(UserWarning):
    """A metric is ill-defined for this input (e.g. a single-class fold)
    and a degenerate value was returned instead of raising. The JAX
    package subclasses scikit-learn's class of this name; the port has
    no scikit-learn, so this is a UserWarning of its own."""


def _device_of(*arrays):
    for a in arrays:
        if isinstance(a, ShardedArray):
            return a.device
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _tensor(a, device):
    """``a`` (host array, tensor or ShardedArray's logical rows) as a
    tensor on ``device``."""
    if isinstance(a, ShardedArray):
        a = a.data[: a.n_rows]
    if isinstance(a, torch.Tensor):
        return a.to(device)
    arr = np.asarray(a)
    if arr.dtype == object:
        arr = arr.astype(np.float64)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr).copy()
    return torch.from_numpy(arr).to(device)


def _canon(y_true, y_pred, sample_weight=None):
    """(t, p, weights, n) as tensors on the data's device; weights are
    float64 ``sample_weight`` (ones without one)."""
    dev = _device_of(y_true, y_pred, sample_weight)
    t = _tensor(y_true, dev)
    p = _tensor(y_pred, dev)
    w = torch.ones(t.shape[0], dtype=torch.float64, device=dev)
    if sample_weight is not None:
        w = w * _tensor(sample_weight, dev).to(torch.float64)
    return t, p, w, int(t.shape[0])


def _f64(a):
    return a.to(torch.float64)


def accuracy_score(y_true, y_pred, normalize=True, sample_weight=None):
    t, p, w, _ = _canon(y_true, y_pred, sample_weight)
    hits = ((t == p).to(torch.float64) * w).sum()
    if not normalize:
        return float(hits)
    return float(hits / w.sum())


def _host(a):
    if isinstance(a, ShardedArray):
        return a.to_numpy()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _resolve_labels(y_true, y_pred, labels):
    """Sorted class values as a host array: explicit ``labels`` (scorers
    forward ``estimator.classes_``), else the union of the uniques of
    y_true and y_pred (scikit-learn's rule: a fold whose y_true misses a
    class the model still predicts scores)."""
    if labels is not None:
        return np.sort(np.asarray(labels))
    u = np.unique(_host(y_true))
    if y_pred is not None:
        u = np.union1d(u, np.unique(_host(y_pred)))
    return u


def _codes(values, classes_host, w, what):
    """Class values to codes 0..C-1 by searchsorted in the values' own
    dtype; rows of weight 0 are exempt from the membership check."""
    classes_d = torch.as_tensor(classes_host, device=values.device).to(
        values.dtype)
    idx = torch.searchsorted(classes_d, values.contiguous()).clamp(
        0, len(classes_host) - 1)
    ok = bool(((classes_d[idx] == values) | (w == 0)).all())
    if not ok:
        raise ValueError(f"{what} contains values not in labels")
    return idx


def _seg_sum(values, index, n):
    return torch.zeros(n, dtype=values.dtype, device=values.device
                       ).index_add_(0, index, values)


def _counts(y_true, y_pred, labels, sample_weight):
    """Per-class (true positives, true counts, predicted counts) as host
    float64 arrays, and the classes."""
    t, p, w, _ = _canon(y_true, y_pred, sample_weight)
    classes = _resolve_labels(y_true, y_pred, labels)
    C = len(classes)
    tc = _codes(t, classes, w, "y_true")
    pc = _codes(p, classes, w, "y_pred")
    tp = _seg_sum(w * (tc == pc).to(torch.float64), tc, C)
    true_c = _seg_sum(w, tc, C)
    pred_c = _seg_sum(w, pc, C)
    return (tp.cpu().numpy(), true_c.cpu().numpy(), pred_c.cpu().numpy(),
            classes)


def _averaged(num, den_p, den_r, classes, average, pos_label, what):
    """scikit-learn's averaging over per-class statistics; ``num`` = tp,
    ``den_p`` = predicted counts, ``den_r`` = true counts."""
    true_c = den_r

    def safe(a, b):
        return np.where(b > 0, a / np.maximum(b, 1e-300), 0.0)

    prec, rec = safe(num, den_p), safe(num, den_r)
    f1 = safe(2 * prec * rec, prec + rec)
    per_class = {"precision": prec, "recall": rec, "f1": f1}[what]
    if average == "binary":
        if len(classes) > 2:
            raise ValueError(
                "average='binary' requires binary targets; use "
                "average='macro'|'micro'|'weighted'"
            )
        where = np.flatnonzero(classes == pos_label)
        if len(where) == 0:
            raise ValueError(
                f"pos_label={pos_label} is not a valid label: "
                f"{classes.tolist()}"
            )
        return float(per_class[where[0]])
    if average == "micro":
        tp_s, fp_s = num.sum(), (den_p - num).sum()
        fn_s = (den_r - num).sum()
        p_ = tp_s / max(tp_s + fp_s, 1e-300)
        r_ = tp_s / max(tp_s + fn_s, 1e-300)
        if what == "precision":
            return float(p_) if (tp_s + fp_s) > 0 else 0.0
        if what == "recall":
            return float(r_) if (tp_s + fn_s) > 0 else 0.0
        return float(2 * p_ * r_ / max(p_ + r_, 1e-300))
    if average == "macro":
        return float(per_class.mean())
    if average == "weighted":
        wts = true_c / max(true_c.sum(), 1e-300)
        return float((per_class * wts).sum())
    if average is None:
        return per_class
    raise ValueError(f"Unknown average {average!r}")


def _prf(y_true, y_pred, what, average, pos_label, labels, sample_weight):
    tp, true_c, pred_c, classes = _counts(y_true, y_pred, labels,
                                          sample_weight)
    return _averaged(tp, pred_c, true_c, classes, average, pos_label, what)


def precision_score(y_true, y_pred, average="binary", pos_label=1,
                    labels=None, sample_weight=None):
    return _prf(y_true, y_pred, "precision", average, pos_label, labels,
                sample_weight)


def recall_score(y_true, y_pred, average="binary", pos_label=1,
                 labels=None, sample_weight=None):
    return _prf(y_true, y_pred, "recall", average, pos_label, labels,
                sample_weight)


def f1_score(y_true, y_pred, average="binary", pos_label=1, labels=None,
             sample_weight=None):
    return _prf(y_true, y_pred, "f1", average, pos_label, labels,
                sample_weight)


def balanced_accuracy_score(y_true, y_pred, sample_weight=None,
                            labels=None):
    """Mean per-class recall over the classes present in y_true."""
    tp, true_c, _, _ = _counts(y_true, y_pred, labels, sample_weight)
    present = true_c > 0
    return float((tp[present] / true_c[present]).mean())


def confusion_matrix(y_true, y_pred, labels=None, sample_weight=None):
    """(C, C) weighted confusion counts: one index_add over the flattened
    (true, pred) code pairs."""
    t, p, w, _ = _canon(y_true, y_pred, sample_weight)
    classes = _resolve_labels(y_true, y_pred, labels)
    C = len(classes)
    tc = _codes(t, classes, w, "y_true")
    pc = _codes(p, classes, w, "y_pred")
    cm = _seg_sum(w, tc * C + pc, C * C).cpu().numpy().reshape(C, C)
    return cm.astype(np.int64) if sample_weight is None else cm


def _binary_targets(t, w, labels, what="roc_auc_score"):
    """0/1 float64 targets from binary labels; explicit ``labels`` are
    positional ([neg, pos]). Without them roc_auc_score takes the larger
    label as positive, and the curve metrics accept only the {0, 1} and
    {-1, 1} codings (their value depends on the guess)."""
    tf = _f64(t)
    if labels is not None:
        lab = np.asarray(labels, dtype=np.float64)
        if len(lab) != 2:
            raise ValueError(f"{what} needs exactly 2 labels")
        if lab[0] == lab[1]:
            raise ValueError(
                f"{what} labels must be two distinct values, got "
                f"{list(np.asarray(labels))}"
            )
        mx_h = float(lab[1])
        ok = bool(((tf == float(lab[0])) | (tf == mx_h) | (w == 0)).all())
        if not ok:
            raise ValueError("y_true contains values not in labels")
    else:
        valid = w > 0
        mn_h = float(torch.where(valid, tf, torch.inf).min())
        mx_h = float(torch.where(valid, tf, -torch.inf).max())
        if not bool(((tf == mn_h) | (tf == mx_h) | (w == 0)).all()):
            raise ValueError(
                f"multiclass format is not supported by {what}; "
                "pass binary targets (or labels= with 2 classes)"
            )
        strict = what != "roc_auc_score"
        if mn_h == mx_h:
            if mx_h in (0.0, -1.0) or (not strict and mx_h != 1.0):
                # a lone non-positive class: no positives
                return torch.zeros_like(tf)
            if strict and mx_h != 1.0:
                raise ValueError(
                    f"y_true takes the value {{{mx_h}}} and the positive "
                    f"class is ambiguous; pass labels=[neg, pos] to {what}"
                )
        elif strict and (mn_h, mx_h) not in ((0.0, 1.0), (-1.0, 1.0)):
            raise ValueError(
                f"y_true takes values in {{{mn_h}, {mx_h}}} and the "
                "positive class is ambiguous; pass labels=[neg, pos] "
                f"to {what}"
            )
    return (tf == mx_h).to(torch.float64)


def _score_column(s, what):
    if s.ndim == 2:
        if s.shape[1] != 2:
            raise ValueError(f"{what} supports binary targets; got "
                             f"{s.shape[1]}-column scores")
        s = s[:, 1]
    return s


def roc_auc_score(y_true, y_score, sample_weight=None, labels=None):
    """Binary ROC-AUC as the tie-corrected rank statistic (Mann-Whitney U
    with ties at half credit, equal to the trapezoidal area): sort by
    score, each positive earns the negative weight strictly below its tie
    group plus half of its group's."""
    t, s, w, _ = _canon(y_true, y_score, sample_weight)
    s = _score_column(s, "roc_auc_score")
    yt = _binary_targets(t, w, labels)
    s32 = s.to(torch.float32)
    order = torch.argsort(s32, stable=True)
    ss, yy, ww = s32[order], yt[order], w[order]
    posw = ww * yy
    negw = ww * (1.0 - yy)
    n = ss.shape[0]
    gid = torch.cat([torch.zeros(1, dtype=torch.long, device=ss.device),
                     torch.cumsum((ss[1:] != ss[:-1]).long(), 0)])
    gneg = _seg_sum(negw, gid, n)
    bneg = torch.cumsum(gneg, 0) - gneg
    num = float((posw * (bneg[gid] + 0.5 * gneg[gid])).sum())
    wp, wn = float(posw.sum()), float(negw.sum())
    if wp == 0.0 or wn == 0.0:
        raise ValueError(
            "Only one class present in y_true. ROC AUC score is not "
            "defined in that case."
        )
    return num / (wp * wn)


def _curve_host(y_true, y_score, sample_weight, labels, what):
    """(distinct thresholds descending, tp and fp weight at each, P, N):
    a device sort, then float64 prefix sums on the host; groups made only
    of zero-weight rows are dropped."""
    t, s, w, _ = _canon(y_true, y_score, sample_weight)
    s = _score_column(s, what)
    yt = _binary_targets(t, w, labels, what)
    s64 = _f64(s)
    order = torch.argsort(-s64, stable=True)
    ss = s64[order].cpu().numpy()
    yo = yt[order].cpu().numpy()
    wo = w[order].cpu().numpy()
    pw, nw, vf = wo * yo, wo * (1.0 - yo), (wo != 0).astype(float)
    tp, fp, cv = np.cumsum(pw), np.cumsum(nw), np.cumsum(vf)
    P, N = float(tp[-1]), float(fp[-1])
    keep = np.r_[ss[1:] != ss[:-1], True]
    ss, tp, fp, cv = ss[keep], tp[keep], fp[keep], cv[keep]
    real = np.diff(np.r_[0.0, cv]) > 0
    return ss[real], tp[real], fp[real], P, N


def _pr_points(tp, fp, P):
    prec = tp / np.maximum(tp + fp, 1e-300)
    return prec, tp / P


def roc_curve(y_true, y_score, sample_weight=None, labels=None):
    """(fpr, tpr, thresholds); collinear intermediate points are kept. A
    fold without positives (or negatives) warns and returns a NaN axis."""
    ss, tp, fp, P, N = _curve_host(y_true, y_score, sample_weight,
                                   labels, "roc_curve")
    if P == 0.0:
        warnings.warn(
            "No positive samples in y_true; true positive rate is "
            "meaningless", UndefinedMetricWarning,
        )
        tpr = np.full(tp.shape[0] + 1, np.nan)
    else:
        tpr = np.r_[0.0, tp / P]
    if N == 0.0:
        warnings.warn(
            "No negative samples in y_true; false positive rate is "
            "meaningless", UndefinedMetricWarning,
        )
        fpr = np.full(fp.shape[0] + 1, np.nan)
    else:
        fpr = np.r_[0.0, fp / N]
    return fpr, tpr, np.r_[np.inf, ss]


def precision_recall_curve(y_true, y_score, sample_weight=None,
                           labels=None):
    """(precision, recall, thresholds) in scikit-learn's orientation:
    thresholds ascending, a final (1, 0) point."""
    ss, tp, fp, P, _ = _curve_host(y_true, y_score, sample_weight,
                                   labels, "precision_recall_curve")
    if P == 0.0:
        warnings.warn(
            "No positive samples in y_true; recall is meaningless",
            UndefinedMetricWarning,
        )
        prec = np.zeros_like(tp)
        rec = np.ones_like(tp)
        return (np.r_[prec[::-1], 1.0], np.r_[rec[::-1], 0.0], ss[::-1])
    prec, rec = _pr_points(tp, fp, P)
    return np.r_[prec[::-1], 1.0], np.r_[rec[::-1], 0.0], ss[::-1]


def average_precision_score(y_true, y_score, sample_weight=None,
                            labels=None):
    """AP = Σ (R_i − R_{i−1}) P_i over descending thresholds; 0 with a
    warning on a fold without positives."""
    ss, tp, fp, P, _ = _curve_host(y_true, y_score, sample_weight,
                                   labels, "average_precision_score")
    if P == 0.0:
        warnings.warn(
            "No positive samples in y_true; average precision is 0",
            UndefinedMetricWarning,
        )
        return 0.0
    prec, rec = _pr_points(tp, fp, P)
    rec_prev = np.r_[0.0, rec[:-1]]
    return float(np.sum((rec - rec_prev) * prec))


def log_loss(y_true, y_prob, eps=1e-15, sample_weight=None, labels=None):
    t, p, w, _ = _canon(y_true, y_prob, sample_weight)
    p = _f64(p).clamp(eps, 1.0 - eps)
    if p.ndim == 2 and p.shape[1] > 2:
        # multiclass: column c is the c-th sorted class; a fold missing a
        # class needs labels= to say which column is which
        if labels is not None:
            classes = np.sort(np.asarray(labels))
        else:
            classes = np.unique(_host(y_true))
        if len(classes) != p.shape[1]:
            raise ValueError(
                f"y_true has {len(classes)} classes but y_prob has "
                f"{p.shape[1]} columns; pass labels= with every class"
            )
        p = p / p.sum(1, keepdim=True)
        idx = _codes(t, classes, w, "y_true")
        p_true = p.gather(1, idx[:, None])[:, 0]
        ll = -torch.log(p_true.clamp(eps, 1.0))
        return float((ll * w).sum() / w.sum())
    if p.ndim == 2:
        p = p[:, 1]
    tf = _f64(t)
    if labels is not None:
        lab = np.sort(np.asarray(labels))
        if len(lab) != 2:
            raise ValueError("binary y_prob needs exactly 2 labels")
        mn_h, mx_h = float(lab[0]), float(lab[1])
    else:
        valid = w > 0
        mn_h = float(torch.where(valid, tf, torch.inf).min())
        mx_h = float(torch.where(valid, tf, -torch.inf).max())
        if mn_h == mx_h:
            raise ValueError(
                "y_true contains a single class; pass labels= to fix "
                "the class order"
            )
    if not bool(((tf == mn_h) | (tf == mx_h) | (w == 0)).all()):
        raise ValueError("y_true contains values not in labels")
    tf = (tf == mx_h).to(torch.float64)
    ll = -(tf * torch.log(p) + (1.0 - tf) * torch.log1p(-p))
    return float((ll * w).sum() / w.sum())
