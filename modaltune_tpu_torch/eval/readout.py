"""Host-side readout heads: logistic regression + Cox proportional
hazards over exported task-conditioned embeddings.

The port's copy of the JAX package's ``eval/readout.py``, itself a port
of ``utils/test_utils_modaltune.py:37-171``: per task embedding, a
logistic regression scores subtype accuracy / balanced accuracy and a
ridge-penalized CoxPH (penalizer 0.1) scores the survival concordance
index. ``TASK_NAMES``, ``filter_labelset``, ``concordance_index``,
``CoxPH`` and ``perform_testing`` are the JAX package's code as it is
(numpy only). The JAX package fits and scores through sklearn, which the
port does without:

* :func:`fit_logreg` minimises liblinear's objective exactly (Newton's
  method in fp64), where liblinear stops at its tolerance;
* :func:`classification_metrics` and :func:`roc_curve_points` compute
  sklearn's metrics, ROC points and AUC by their definitions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

TASK_NAMES = ("General", "Diagnosis", "Survival")  # utils/constants.py:45-49


def filter_labelset(x: np.ndarray, y: np.ndarray):
    """Keep rows with label >= 0 (rare labels are mapped to -1 by the
    split maker — ``test_utils_modaltune.py:37-45``)."""
    idx = np.where(y >= 0)[0]
    return x[idx], y[idx]


def concordance_index(durations: np.ndarray, risks: np.ndarray,
                      events: np.ndarray) -> float:
    """C-index with the convention higher risk => earlier event.

    Comparable pairs: (i, j) with T_i < T_j and E_i = 1, plus tied-time
    pairs with exactly one event. Ties in risk count 0.5.
    """
    t = np.asarray(durations, float)
    r = np.asarray(risks, float)
    e = np.asarray(events, bool)
    n = len(t)
    num = den = 0.0
    for i in range(n):
        if not e[i]:
            continue
        # j strictly later than i, or tied time with j censored
        later = (t > t[i]) | ((t == t[i]) & ~e)
        later[i] = False
        den += later.sum()
        num += (r[i] > r[later]).sum() + 0.5 * (r[i] == r[later]).sum()
    return float(num / den) if den > 0 else 0.5


@dataclasses.dataclass
class CoxPH:
    """Ridge-penalized Cox proportional hazards (Efron ties)."""

    penalizer: float = 0.1
    max_iter: int = 50
    tol: float = 1e-7
    beta: Optional[np.ndarray] = None
    _mean: Optional[np.ndarray] = None
    _std: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray, durations: np.ndarray,
            events: np.ndarray, strata=None) -> "CoxPH":
        """Newton with analytic Efron gradient/Hessian, pure numpy fp64
        (the design matrix is (N, 256); each Newton step is a handful of
        small matmuls — no accelerator needed).

        ``strata``: optional per-row labels; the partial likelihood is
        computed within each stratum and summed (lifelines'
        ``strata=`` used by the pan-cancer pooled survival model,
        ``utils/test_utils_pancancer.py:70-88``)."""
        x = np.asarray(x, np.float64)
        t = np.asarray(durations, np.float64)
        e = np.asarray(events, np.float64)
        keep = np.isfinite(t) & np.isfinite(x).all(axis=1)
        x, t, e = x[keep], t[keep], e[keep]
        strata_arr = None
        if strata is not None:
            strata_arr = np.asarray(strata)[keep]
        self._mean = x.mean(axis=0)
        self._std = x.std(axis=0)
        self._std[self._std == 0] = 1.0
        xs = (x - self._mean) / self._std

        # sort by (stratum, time); risk sets never cross strata
        if strata_arr is not None:
            s_codes = np.unique(strata_arr, return_inverse=True)[1]
        else:
            s_codes = np.zeros(len(t), np.int64)
        order = np.lexsort((t, s_codes))
        xs, t, e, s_codes = xs[order], t[order], e[order], s_codes[order]
        n, p = xs.shape
        # unique (stratum, time) pairs in sorted order
        keys = np.stack([s_codes, t], axis=1)
        _, inv = np.unique(keys, axis=0, return_inverse=True)
        nuniq = inv.max() + 1 if n else 0
        groups = [np.where(inv == k)[0] for k in range(nuniq)]
        ev_groups = [g[e[g] > 0] for g in groups]
        # stratum of each unique group (groups are time-sorted within
        # stratum; risk-set accumulator resets at stratum boundaries)
        group_strata = np.array([s_codes[g[0]] for g in groups]) \
            if nuniq else np.zeros(0, np.int64)

        def nll_grad_hess(beta):
            r = xs @ beta
            r = np.clip(r, -500, 500)
            w = np.exp(r)
            wx = w[:, None] * xs
            ll = 0.0
            grad = np.zeros(p)
            hess = np.zeros((p, p))
            # running risk-set sums, accumulated from latest time down,
            # reset at stratum boundaries
            s0 = 0.0
            s1 = np.zeros(p)
            s2 = np.zeros((p, p))
            prev_stratum = None
            for k in range(nuniq - 1, -1, -1):
                if prev_stratum is not None and \
                        group_strata[k] != prev_stratum:
                    s0 = 0.0
                    s1 = np.zeros(p)
                    s2 = np.zeros((p, p))
                prev_stratum = group_strata[k]
                g = groups[k]
                xg = xs[g]
                s0 += w[g].sum()
                s1 += wx[g].sum(axis=0)
                s2 += wx[g].T @ xg
                d = ev_groups[k]
                if len(d) == 0:
                    continue
                dn = len(d)
                xd = xs[d]
                wd0 = w[d].sum()
                wd1 = wx[d].sum(axis=0)
                wd2 = wx[d].T @ xd
                ll += r[d].sum()
                grad += xd.sum(axis=0)
                for l in range(dn):
                    f = l / dn
                    phi = s0 - f * wd0
                    a = s1 - f * wd1
                    b = s2 - f * wd2
                    ll -= np.log(max(phi, 1e-300))
                    grad -= a / phi
                    hess -= b / phi - np.outer(a, a) / phi ** 2
            # L2 penalizer (ridge), lifelines-style scaled by n
            pen = 0.5 * self.penalizer * n
            nll = -ll + pen * beta @ beta
            ngrad = -grad + 2 * pen * beta
            nhess = -hess + 2 * pen * np.eye(p)
            return nll, ngrad, nhess

        beta = np.zeros(p)
        prev, g, h = nll_grad_hess(beta)
        for _ in range(self.max_iter):
            step = np.linalg.solve(h + 1e-9 * np.eye(p), g)
            lr, val = 1.0, np.inf
            for _ls in range(25):
                cand = beta - lr * step
                val, gc, hc = nll_grad_hess(cand)
                if np.isfinite(val) and val <= prev:
                    break
                lr *= 0.5
            beta, g, h = cand, gc, hc
            if abs(prev - val) < self.tol * (abs(prev) + 1.0):
                break
            prev = val
        self.beta = beta
        return self

    def risk(self, x: np.ndarray) -> np.ndarray:
        xs = (np.asarray(x, np.float64) - self._mean) / self._std
        return xs @ self.beta

    def score(self, x, durations, events) -> float:
        t = np.asarray(durations, float)
        keep = np.isfinite(t) & np.isfinite(np.asarray(x, float)).all(axis=1)
        return concordance_index(t[keep], self.risk(np.asarray(x)[keep]),
                                 np.asarray(events)[keep])


class LogReg:
    """A fitted logistic readout with sklearn's interface: ``classes_``,
    ``coef_`` (one row per binary fit), ``intercept_``,
    :meth:`decision_function`, :meth:`predict`, :meth:`predict_proba`.

    Two classes: one fit, ``classes_[1]`` the positive class. More: one
    binary fit per class (``y == c``), as ``OneVsRestClassifier``."""

    def __init__(self, classes: np.ndarray, coef: np.ndarray,
                 intercept: np.ndarray):
        self.classes_ = classes
        self.coef_ = coef
        self.intercept_ = intercept

    def decision_function(self, x) -> np.ndarray:
        d = np.asarray(x, np.float64) @ self.coef_.T + self.intercept_
        return d[:, 0] if len(self.classes_) == 2 else d

    def predict(self, x) -> np.ndarray:
        d = self.decision_function(x)
        if len(self.classes_) == 2:
            return self.classes_[(d > 0).astype(int)]
        return self.classes_[np.argmax(d, axis=1)]

    def predict_proba(self, x) -> np.ndarray:
        p = _sigmoid(self.decision_function(x))
        if len(self.classes_) == 2:
            return np.stack([1.0 - p, p], axis=1)
        return p / p.sum(axis=1, keepdims=True)


def _sigmoid(z: np.ndarray) -> np.ndarray:
    return np.exp(-np.logaddexp(0.0, -z))


def _fit_binary(x: np.ndarray, positive: np.ndarray, c: float = 1.0,
                rtol: float = 1e-10, max_iter: int = 100) -> np.ndarray:
    """-> (D + 1,) weights, the bias last: the minimiser of liblinear's
    L2-regularised logistic objective ``0.5 |w|^2 + c sum log(1 +
    exp(-y (w . [x, 1])))``, y = +-1, the bias a regularised feature of
    value 1 (sklearn's ``intercept_scaling=1``). Newton's method with a
    Cholesky solve of the (D + 1)^2 Hessian and a backtracking line search,
    iterated to a gradient norm of ``rtol`` x its start."""
    xa = np.hstack([x, np.ones((len(x), 1))])
    y = np.where(positive, 1.0, -1.0)

    def objective(w):
        return 0.5 * w @ w + c * np.logaddexp(0.0, -y * (xa @ w)).sum()

    w = np.zeros(xa.shape[1])
    f = objective(w)
    g0 = None
    for _ in range(max_iter):
        yz = y * (xa @ w)
        grad = w - c * xa.T @ (y * _sigmoid(-yz))
        gnorm = np.linalg.norm(grad)
        g0 = gnorm if g0 is None else g0
        if gnorm <= rtol * g0:
            break
        curv = _sigmoid(yz) * _sigmoid(-yz)
        hess = c * (xa.T * curv) @ xa
        hess[np.diag_indices_from(hess)] += 1.0
        low = np.linalg.cholesky(hess)
        step = np.linalg.solve(low.T, np.linalg.solve(low, grad))
        t = 1.0
        while True:
            cand = w - t * step
            f_cand = objective(cand)
            if f_cand <= f - 1e-4 * t * (grad @ step) or t < 1e-10:
                break
            t *= 0.5
        if f_cand > f:
            break
        w, f = cand, f_cand
    return w


def fit_logreg(x_train, y_train, seed: int = 0) -> LogReg:
    """L2-regularised logistic regression at liblinear's defaults as the
    JAX package calls it (``C=1``, ``intercept_scaling=1``), one-vs-rest
    for more than two classes (test_utils_modaltune.py:56-58). ``seed``
    is kept for the JAX signature; the exact minimiser needs none."""
    x, y = filter_labelset(np.asarray(x_train),
                           np.asarray(y_train, int).ravel())
    x = np.asarray(x, np.float64)
    classes = np.unique(y)
    if len(classes) < 2:
        raise ValueError(f"fit_logreg needs samples of at least 2 classes, "
                         f"got {classes.tolist()}")
    targets = [classes[1]] if len(classes) == 2 else list(classes)
    ws = np.stack([_fit_binary(x, y == t) for t in targets])
    return LogReg(classes, ws[:, :-1], ws[:, -1])


def _confusion(y_true, y_pred, labels) -> np.ndarray:
    pos = {int(v): i for i, v in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(y_true, y_pred):
        cm[pos[int(t)], pos[int(p)]] += 1
    return cm


def _ratio(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (sklearn's ``zero_division=0``)."""
    num, den = np.asarray(num, float), np.asarray(den, float)
    return np.divide(num, den, out=np.zeros_like(num), where=den > 0)


def classification_metrics(y_true, y_pred,
                           y_probs=None) -> Dict[str, float]:
    """acc / balanced acc / recall / precision / F1 (+ ROC AUC and the
    confusion matrix when probabilities are given) — the metric set the
    reference logs to wandb (train_modaltune.py:479-497). The values of
    the JAX package's sklearn calls: balanced accuracy is the mean recall
    over the classes present in ``y_true``; precision, recall and F1 are
    of class 1 ("binary") unless a label other than 0 and 1 occurs in
    either array, then their mean over the labels of both ("macro")."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    # "binary" requires labels in {0,1} across BOTH arrays; a predicted
    # unseen class must flip to macro averaging
    all_labels = np.unique(np.concatenate([y_true, y_pred]))
    avg = "macro" if len(all_labels) > 2 or all_labels.max(initial=0) > 1 \
        else "binary"
    cm = _confusion(y_true, y_pred, all_labels)
    tp = np.diag(cm)
    true_n, pred_n = cm.sum(axis=1), cm.sum(axis=0)
    recall, precision = _ratio(tp, true_n), _ratio(tp, pred_n)
    f1 = _ratio(2 * tp, true_n + pred_n)
    if avg == "binary":
        k = [i for i, v in enumerate(all_labels) if v == 1]
        pick = (lambda a: float(a[k[0]])) if k else (lambda a: 0.0)
    else:
        pick = lambda a: float(np.mean(a))  # noqa: E731
    out = dict(
        acc=float(np.mean(y_true == y_pred)),
        bal_acc=float(np.mean(recall[true_n > 0])),
        recall=pick(recall), precision=pick(precision), f1=pick(f1))
    if y_probs is not None and len(np.unique(y_true)) > 1:
        auc = _roc_auc(y_true, np.asarray(y_probs))
        if auc is not None:
            out["auc"] = auc
        labels = np.unique(np.concatenate([y_true, y_pred]))
        out["confusion_matrix"] = _confusion(y_true, y_pred,
                                             labels).tolist()
        out["roc_curve"] = roc_curve_points(y_true, y_probs)
    return out


def _roc(positive: np.ndarray, score: np.ndarray):
    """sklearn's ``roc_curve(drop_intermediate=True)``: (fpr, tpr) with the
    scores sorted descending, one point per distinct score, the points
    where neither fps nor tps bends dropped (both ends kept), then (0, 0)
    prepended."""
    order = np.argsort(score, kind="mergesort")[::-1]
    score, hit = score[order], positive[order].astype(np.float64)
    idx = np.r_[np.where(np.diff(score))[0], hit.size - 1]
    tps = np.cumsum(hit)[idx]
    fps = 1 + idx - tps
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    fps, tps = np.r_[0, fps], np.r_[0, tps]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr


# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _binary_auc(positive: np.ndarray, score: np.ndarray) -> float:
    fpr, tpr = _roc(positive, score)
    return float(_trapezoid(tpr, fpr))


def _roc_auc(y_true: np.ndarray, probs: np.ndarray) -> Optional[float]:
    """sklearn's ``roc_auc_score`` as the JAX package calls it: binary on
    column 1 of two, else the macro mean of one-vs-rest AUCs over the
    classes of ``y_true`` (column k the k-th class); None where sklearn
    raises (columns that do not match the classes, rows that do not sum
    to 1)."""
    classes = np.unique(y_true)
    if probs.ndim != 2:
        return None
    if probs.shape[1] == 2:
        if len(classes) != 2:
            return None
        return _binary_auc(y_true == classes[1], probs[:, 1])
    if probs.shape[1] != len(classes) or \
            not np.allclose(1, probs.sum(axis=1)):
        return None
    return float(np.mean([_binary_auc(y_true == c, probs[:, k])
                          for k, c in enumerate(classes)]))


def roc_curve_points(y_true, y_probs) -> Dict[str, object]:
    """fpr/tpr point lists for export — the data behind the reference's
    wandb ROC plot (``wandb.plot.roc_curve``, train_modaltune.py:496).
    Binary: one curve on the positive-class score; multiclass: one
    one-vs-rest curve per class, keyed ``"class_<k>"``."""
    y_true = np.asarray(y_true)
    probs = np.asarray(y_probs)
    classes = np.unique(y_true)
    out: Dict[str, object] = {}
    if probs.ndim == 2 and probs.shape[1] == 2 and len(classes) == 2:
        fpr, tpr = _roc(y_true == classes[1], probs[:, 1])
        out["fpr"], out["tpr"] = fpr.tolist(), tpr.tolist()
    elif probs.ndim == 2:
        for k in classes:
            if int(k) >= probs.shape[1]:
                continue
            fpr, tpr = _roc(y_true == k, probs[:, int(k)])
            out[f"class_{int(k)}"] = {"fpr": fpr.tolist(),
                                      "tpr": tpr.tolist()}
    return out


def perform_testing(x_train: np.ndarray, meta_train: Sequence[dict],
                    x_test: np.ndarray, meta_test: Sequence[dict],
                    penalizer: float = 0.1,
                    label_key: str = "primary_class") -> Dict[str, dict]:
    """Per-task LogReg + CoxPH readout (``perform_testing``,
    test_utils_modaltune.py:133-171).

    x_*: (N, n_tasks, dim) embeddings; meta_*: per-case dicts with
    ``primary_class``, ``durations``, ``vital_status``.
    Returns {task_name: {"c_index": ..., "acc": ..., "bal_acc": ...}}.
    """
    y_train = np.array([m.get(label_key, -1) for m in meta_train], float)
    y_test = np.array([m.get(label_key, -1) for m in meta_test], float)
    y_train = np.nan_to_num(y_train, nan=-1).astype(int)
    y_test = np.nan_to_num(y_test, nan=-1).astype(int)
    t_train = np.array([m.get("durations", np.nan) for m in meta_train],
                       float)
    e_train = np.array([m.get("vital_status", 0) for m in meta_train], int)
    t_test = np.array([m.get("durations", np.nan) for m in meta_test],
                      float)
    e_test = np.array([m.get("vital_status", 0) for m in meta_test], int)

    results = {}
    n_tasks = x_train.shape[1]
    for i in range(n_tasks):
        name = TASK_NAMES[i] if i < len(TASK_NAMES) else f"task{i}"
        res = {}
        cph = CoxPH(penalizer=penalizer).fit(x_train[:, i], t_train,
                                             e_train)
        res["c_index"] = cph.score(x_test[:, i], t_test, e_test)
        clf = fit_logreg(x_train[:, i], y_train)
        xt, yt = filter_labelset(x_test[:, i], y_test)
        if len(yt):
            res.update(classification_metrics(yt, clf.predict(xt)))
        results[name] = res
    return results
