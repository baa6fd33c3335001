"""Prediction quality metrics: SMSE and NLPD (host numpy copy of
runlmc_tpu/utils/evaluation.py).

Definition parity: reference benchmarks/benchlib/standard_tester.py:205-233
(including the skip-empty-outputs and zero-variance filtering behavior)."""

import logging

import numpy as np

_LOG = logging.getLogger(__name__)


def _nonempty(*lists):
    ixs = [i for i, x in enumerate(lists[0]) if len(x) > 0]
    return tuple([ls[i] for i in ixs] for ls in lists)


def smse(test_yss, pred_yss, train_yss):
    """Standardized mean squared error, averaged over (non-empty)
    outputs; the normalizer is the trivial train-mean predictor."""
    test_yss, pred_yss, train_yss = _nonempty(test_yss, pred_yss, train_yss)
    vals = [
        np.square(t - p).mean() / np.square(tr.mean() - t).mean()
        for t, p, tr in zip(test_yss, pred_yss, train_yss)
    ]
    return float(np.mean(vals))


def nlpd(test_yss, pred_yss, pred_vss):
    """Negative log predictive density under the Gaussian predictive
    marginals, averaged per point then over outputs. Zero predictive
    variances are filtered with a warning."""
    test_yss, pred_yss, pred_vss = _nonempty(test_yss, pred_yss, pred_vss)
    sel = [np.flatnonzero(np.asarray(v)) for v in pred_vss]
    skipped = sum(len(v) - len(s) for v, s in zip(pred_vss, sel))
    if skipped:
        _LOG.warning(
            "found %d of %d predictive variances set to 0",
            skipped,
            sum(map(len, pred_vss)),
        )
    test_yss = [np.asarray(t)[s] for t, s in zip(test_yss, sel)]
    pred_yss = [np.asarray(p)[s] for p, s in zip(pred_yss, sel)]
    pred_vss = [np.asarray(v)[s] for v, s in zip(pred_vss, sel)]
    test_yss, pred_yss, pred_vss = _nonempty(test_yss, pred_yss, pred_vss)
    vals = [
        0.5 * np.mean(np.square(t - p) / v + np.log(2 * np.pi * v))
        for t, p, v in zip(test_yss, pred_yss, pred_vss)
    ]
    return float(np.mean(vals))
