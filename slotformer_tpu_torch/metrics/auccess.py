"""PHYRE AUCCESS: the log-weighted success@k over ranked attempts, the port
of ``slotformer_tpu/metrics/auccess.py`` (reference
phyre_planning/test_phyre_planning.py:198-228)."""

from __future__ import annotations

import numpy as np

# PHYRE simulation status codes
INVALID = 0
SOLVED = 1
FAILED = -1


def auccess_from_conf(all_conf: np.ndarray, all_gt: np.ndarray,
                      attempts: int = 100):
    """AUCCESS over (num_tasks, num_actions) tables of confidences and
    statuses. Invalid actions (status 0) are left out of the ranking; a task
    with fewer than ``attempts`` valid actions keeps its last success value.
    Returns (AUCCESS in percent, success rate at k for k = 1..attempts)."""
    num_tasks = all_gt.shape[0]
    success = np.zeros((num_tasks, attempts))
    for t in range(num_tasks):
        keep = all_gt[t] != INVALID
        conf, gt = all_conf[t][keep], all_gt[t][keep].copy()
        gt[gt == FAILED] = 0
        ranked = gt[np.argsort(conf)[::-1]]
        csum = np.cumsum(ranked[:attempts])
        k = len(csum)
        success[t, :k] = (csum > 0).astype(float)
        if k < attempts:
            success[t, k:] = success[t, k - 1] if k > 0 else 0.0
    w = np.array([np.log(k + 1) - np.log(k) for k in range(1, attempts + 1)])
    s = success.mean(0)
    return float((w * s).sum() / w.sum() * 100.0), s
