"""Pan-cancer readout: per-site + pooled survival, per-site diagnosis,
and 4-way cancer-site classification.

Port of ``utils/test_utils_pancancer.py:70-236``: for each combined site
in PROJECT_ID_MAP, per-task CoxPH (site-local) plus a pooled CoxPH fit
on all sites (optionally stratified by project), per-task liblinear
LogReg for the site's subtype labels, and a cross-site classifier over
``SITE_LABEL``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..utils.constants import NUM_SITES, PROJECT_ID_MAP, SITE_LABEL
from .readout import (CoxPH, TASK_NAMES, classification_metrics,
                      filter_labelset, fit_logreg)


def _meta_arrays(meta: Sequence[dict]):
    y = np.array([m.get("primary_class", -1) for m in meta], float)
    y = np.nan_to_num(y, nan=-1).astype(int)
    t = np.array([m.get("durations", np.nan) for m in meta], float)
    e = np.array([m.get("vital_status", 0) for m in meta], int)
    proj = np.array([str(m.get("project_id", "")) for m in meta])
    return y, t, e, proj


def perform_testing_pancancer(x_train: np.ndarray,
                              meta_train: Sequence[dict],
                              x_test: np.ndarray,
                              meta_test: Sequence[dict],
                              penalizer: float = 0.1,
                              strata_pooled: bool = False) -> Dict:
    """x_*: (N, n_tasks, dim); meta rows need ``primary_class``,
    ``durations``, ``vital_status``, ``project_id``. Returns
    {site: {task: {c_index, pooled_c_index, acc, bal_acc, ...}},
     "site_classification": {task: metrics}}."""
    y_tr, t_tr, e_tr, proj_tr = _meta_arrays(meta_train)
    y_te, t_te, e_te, proj_te = _meta_arrays(meta_test)
    n_tasks = x_train.shape[1]

    # pooled survival models over all sites
    pooled = []
    for i in range(n_tasks):
        strata = proj_tr if strata_pooled else None
        pooled.append(CoxPH(penalizer=penalizer).fit(
            x_train[:, i], t_tr, e_tr, strata=strata))

    results: Dict = {}
    for site, projects in PROJECT_ID_MAP.items():
        tr_sel = np.isin(proj_tr, projects)
        te_sel = np.isin(proj_te, projects)
        if tr_sel.sum() == 0 or te_sel.sum() == 0:
            continue
        site_res = {}
        for i in range(n_tasks):
            name = TASK_NAMES[i] if i < len(TASK_NAMES) else f"task{i}"
            r = {}
            cph = CoxPH(penalizer=penalizer).fit(
                x_train[tr_sel, i], t_tr[tr_sel], e_tr[tr_sel])
            r["c_index"] = cph.score(x_test[te_sel, i], t_te[te_sel],
                                     e_te[te_sel])
            r["pooled_c_index"] = pooled[i].score(
                x_test[te_sel, i], t_te[te_sel], e_te[te_sel])
            xf, yf = filter_labelset(x_train[tr_sel, i], y_tr[tr_sel])
            if len(np.unique(yf)) > 1:
                clf = fit_logreg(x_train[tr_sel, i], y_tr[tr_sel])
                xt, yt = filter_labelset(x_test[te_sel, i], y_te[te_sel])
                if len(yt):
                    r.update(classification_metrics(yt, clf.predict(xt)))
            site_res[name] = r
        results[site] = site_res

    # cancer-site classification over SITE_LABEL
    site_tr = np.array([SITE_LABEL.get(p, -1) for p in proj_tr])
    site_te = np.array([SITE_LABEL.get(p, -1) for p in proj_te])
    site_cls = {}
    for i in range(n_tasks):
        name = TASK_NAMES[i] if i < len(TASK_NAMES) else f"task{i}"
        xf, yf = filter_labelset(x_train[:, i], site_tr)
        if len(np.unique(yf)) > 1:
            clf = fit_logreg(x_train[:, i], site_tr)
            xt, yt = filter_labelset(x_test[:, i], site_te)
            if len(yt):
                site_cls[name] = classification_metrics(
                    yt, clf.predict(xt))
    results["site_classification"] = site_cls
    return results
