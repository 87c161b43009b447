"""The port's readout (numpy only) against the JAX package's (sklearn), on
the CPU, on seeded embeddings.

* ``fit_logreg``: the port minimises liblinear's objective exactly,
  sklearn's liblinear stops at its tolerance (1e-4), so the probabilities
  are held at ``PROBA_TOL`` (largest difference measured on these inputs:
  ``PROBA_MEASURED``, at 200 x 256) and the predictions must be equal;
  against liblinear run to a tolerance of 1e-12 they agree to
  ``EXACT_TOL``;
* ``classification_metrics`` on the same labels and probabilities, and
  ``roc_curve_points``: every value equal;
* ``CoxPH``, ``concordance_index`` and ``perform_testing``: the same code,
  the coefficients to 1e-12;
* the cases of ``tests/test_readout.py``, run against the port.
"""

import numpy as np
import pytest

from modaltune_tpu.eval import readout as j_readout
from modaltune_tpu_torch.eval import readout as p_readout

PROBA_TOL = 1e-3
# the largest |predict_proba| difference of the three fits below (5.12e-4;
# 4.3e-5 at 24 x 256, 2.4e-4 for the three classes)
PROBA_MEASURED = 5.2e-4
# against liblinear at tol=1e-12 (2.2e-8 measured at 200 x 256)
EXACT_TOL = 1e-6


def _embeddings(n, d, n_classes, seed):
    rng = np.random.RandomState(seed)
    y = np.arange(n) % n_classes
    rng.shuffle(y)
    centers = rng.randn(n_classes, d) * 0.15
    x = (rng.randn(n, d) + centers[y]).astype(np.float32)
    x_test = (rng.randn(80, d) + centers[rng.randint(0, n_classes, 80)]
              ).astype(np.float32)
    return x, y, x_test


LOGREG_CASES = [(24, 256, 2), (200, 256, 2), (60, 256, 3)]


@pytest.mark.parametrize("n,d,n_classes", LOGREG_CASES,
                         ids=[f"{n}x{d}_{k}cls" for n, d, k in LOGREG_CASES])
def test_fit_logreg_matches_sklearn(n, d, n_classes):
    x, y, x_test = _embeddings(n, d, n_classes, seed=n)
    want = j_readout.fit_logreg(x, y)
    got = p_readout.fit_logreg(x, y)
    assert list(got.classes_) == list(want.classes_)
    pw, pg = want.predict_proba(x_test), got.predict_proba(x_test)
    assert pg.shape == pw.shape == (80, n_classes)
    err = float(np.abs(pg - pw).max())
    assert err <= PROBA_MEASURED <= PROBA_TOL, err
    np.testing.assert_array_equal(got.predict(x_test), want.predict(x_test))
    np.testing.assert_array_equal(got.predict(x), want.predict(x))


def test_fit_logreg_is_liblinears_exact_minimiser():
    from sklearn.linear_model import LogisticRegression
    x, y, x_test = _embeddings(200, 256, 2, seed=200)
    tight = LogisticRegression(solver="liblinear", tol=1e-12,
                               max_iter=100000).fit(x, y)
    got = p_readout.fit_logreg(x, y)
    err = np.abs(got.predict_proba(x_test) - tight.predict_proba(x_test))
    assert float(err.max()) <= EXACT_TOL


def test_fit_logreg_drops_unlabelled_rows_and_needs_two_classes():
    x, y, _ = _embeddings(30, 16, 2, seed=3)
    y[:5] = -1
    got, want = p_readout.fit_logreg(x, y), j_readout.fit_logreg(x, y)
    np.testing.assert_array_equal(got.predict(x), want.predict(x))
    with pytest.raises(ValueError):
        p_readout.fit_logreg(x, np.zeros(30, int))


def _metric_cases():
    rng = np.random.RandomState(4)
    cases = []
    for n_classes in (2, 3):
        x, y, x_test = _embeddings(60, 32, n_classes, seed=n_classes)
        clf = p_readout.fit_logreg(x, y)
        y_true = rng.randint(0, n_classes, 80)
        cases.append((f"{n_classes}cls", y_true, clf.predict(x_test),
                      clf.predict_proba(x_test)))
    # binary labels with a predicted class that y_true lacks: macro
    y_true = np.array([0, 1, 0, 1, 1, 0, 1, 0])
    y_pred = np.array([0, 2, 0, 1, 1, 0, 1, 1])
    cases.append(("unseen_pred", y_true, y_pred, None))
    # one label only, and binary with no class 1 predicted
    cases.append(("one_label", np.zeros(6, int), np.zeros(6, int), None))
    ties = np.array([0.2, 0.2, 0.7, 0.7, 0.5, 0.5, 0.9, 0.1])
    cases.append(("tied_scores", np.array([0, 1, 1, 0, 1, 0, 1, 0]),
                  np.zeros(8, int), np.stack([1 - ties, ties], axis=1)))
    return cases


METRIC_CASES = _metric_cases()


@pytest.mark.parametrize("name,y_true,y_pred,y_probs", METRIC_CASES,
                         ids=[c[0] for c in METRIC_CASES])
def test_classification_metrics_equal_sklearn(name, y_true, y_pred, y_probs):
    want = j_readout.classification_metrics(y_true, y_pred, y_probs=y_probs)
    got = p_readout.classification_metrics(y_true, y_pred, y_probs=y_probs)
    assert got == want


def test_roc_curve_points_equal_sklearn():
    for name, y_true, _, y_probs in METRIC_CASES:
        if y_probs is None:
            continue
        want = j_readout.roc_curve_points(y_true, y_probs)
        got = p_readout.roc_curve_points(y_true, y_probs)
        assert got == want, name
        # per class, on a binary column too
        want = j_readout.roc_curve_points(
            y_true, np.concatenate([y_probs, y_probs[:, :1]], axis=1))
        got = p_readout.roc_curve_points(
            y_true, np.concatenate([y_probs, y_probs[:, :1]], axis=1))
        assert got == want, name


def _survival(n, d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    t = np.round(np.exp(-x[:, 0]) * 10 + rng.rand(n), 1)
    e = (rng.rand(n) < 0.7).astype(int)
    t[::11] = np.nan
    return x, t, e


def test_coxph_and_concordance_equal_jax():
    x, t, e = _survival(80, 12, seed=5)
    strata = np.arange(80) % 3
    for kw in ({}, {"strata": strata}):
        want = j_readout.CoxPH(penalizer=0.1).fit(x, t, e, **kw)
        got = p_readout.CoxPH(penalizer=0.1).fit(x, t, e, **kw)
        np.testing.assert_allclose(got.beta, want.beta, rtol=1e-12,
                                   atol=1e-12)
        assert got.score(x, t, e) == want.score(x, t, e)
    r = np.random.RandomState(6).randn(80)
    keep = np.isfinite(t)
    assert p_readout.concordance_index(t[keep], r[keep], e[keep]) == \
        j_readout.concordance_index(t[keep], r[keep], e[keep])


def _deploy_inputs(seed=0, n_tr=40, n_te=24, tasks=3, dim=16, n_classes=2):
    rng = np.random.RandomState(seed)
    y_tr = np.arange(n_tr) % n_classes
    y_te = rng.randint(0, n_classes, n_te)
    x_tr = rng.randn(n_tr, tasks, dim) + y_tr[:, None, None] * 0.8
    x_te = rng.randn(n_te, tasks, dim) + y_te[:, None, None] * 0.8

    def meta(x, y):
        return [dict(primary_class=int(y[i]),
                     durations=float(np.exp(-x[i, 0, 0]) * 10 + 1),
                     vital_status=int(i % 3 != 0)) for i in range(len(y))]

    return x_tr, meta(x_tr, y_tr), x_te, meta(x_te, y_te)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_perform_testing_equal_jax(n_classes):
    args = _deploy_inputs(n_classes=n_classes)
    assert p_readout.perform_testing(*args) == \
        j_readout.perform_testing(*args)
    assert p_readout.TASK_NAMES == j_readout.TASK_NAMES
    x, y = np.arange(8.0).reshape(4, 2), np.array([1, -1, 0, 2])
    for a, b in zip(p_readout.filter_labelset(x, y),
                    j_readout.filter_labelset(x, y)):
        np.testing.assert_array_equal(a, b)


# --- tests/test_readout.py's cases, against the port ----------------------

def _simulate_cox(n=300, p=4, seed=0):
    rng = np.random.RandomState(seed)
    beta = np.array([1.0, -0.5, 0.0, 0.25])
    x = rng.randn(n, p)
    u = rng.rand(n)
    t = -np.log(u) / np.exp(x @ beta)
    c = rng.exponential(np.median(t) * 2, size=n)
    return x, np.minimum(t, c), (t <= c).astype(int)


def test_port_concordance_perfect_and_random():
    t = np.array([1.0, 2.0, 3.0, 4.0])
    e = np.ones(4, int)
    ci = p_readout.concordance_index
    assert ci(t, np.array([4.0, 3.0, 2.0, 1.0]), e) == 1.0
    assert ci(t, np.array([1.0, 2.0, 3.0, 4.0]), e) == 0.0
    assert ci(t, np.zeros(4), e) == 0.5


def test_port_coxph_recovers_signal_and_handles_ties():
    x, t, e = _simulate_cox()
    cph = p_readout.CoxPH(penalizer=0.01).fit(x, t, e)
    assert cph.beta[0] > 0.3 and cph.beta[1] < -0.1
    assert cph.score(x, t, e) > 0.7
    x, t, e = _simulate_cox(n=120, seed=1)
    t = np.round(t, 1)
    t[::17] = np.nan
    cph = p_readout.CoxPH().fit(x, t, e)
    assert np.all(np.isfinite(cph.beta))
    assert 0.0 <= cph.score(x, t, e) <= 1.0


def test_port_perform_testing_end_to_end():
    rng = np.random.RandomState(0)
    n_tr, n_te, tasks, dim = 80, 40, 3, 16
    y_tr = rng.randint(0, 2, n_tr)
    y_te = rng.randint(0, 2, n_te)
    x_tr = rng.randn(n_tr, tasks, dim) + y_tr[:, None, None] * 2.0
    x_te = rng.randn(n_te, tasks, dim) + y_te[:, None, None] * 2.0
    meta_tr = [dict(primary_class=int(y_tr[i]),
                    durations=float(np.exp(-x_tr[i, 0, 0]) * 10 + 1),
                    vital_status=1) for i in range(n_tr)]
    meta_te = [dict(primary_class=int(y_te[i]),
                    durations=float(np.exp(-x_te[i, 0, 0]) * 10 + 1),
                    vital_status=1) for i in range(n_te)]
    res = p_readout.perform_testing(x_tr, meta_tr, x_te, meta_te)
    assert set(res) == {"General", "Diagnosis", "Survival"}
    assert res["General"]["bal_acc"] > 0.85
    assert res["General"]["c_index"] > 0.6
    for task in res.values():
        assert 0 <= task["c_index"] <= 1


def test_port_roc_curve_points_binary_and_multiclass():
    rng = np.random.RandomState(0)
    y = rng.randint(0, 2, 50)
    p1 = np.clip(y + rng.randn(50) * 0.3, 0, 1)
    probs = np.stack([1 - p1, p1], axis=1)
    pts = p_readout.roc_curve_points(y, probs)
    assert len(pts["fpr"]) == len(pts["tpr"]) >= 2
    assert pts["fpr"][0] == 0.0 and pts["fpr"][-1] == 1.0
    m = p_readout.classification_metrics(y, (p1 > 0.5).astype(int),
                                         y_probs=probs)
    assert "roc_curve" in m and "confusion_matrix" in m
    y3 = rng.randint(0, 3, 60)
    probs3 = rng.rand(60, 3)
    probs3 /= probs3.sum(1, keepdims=True)
    assert set(p_readout.roc_curve_points(y3, probs3)) == \
        {"class_0", "class_1", "class_2"}
