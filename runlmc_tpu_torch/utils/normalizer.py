"""Per-output z-score normalization (host numpy copy of
runlmc_tpu/utils/normalizer.py): z-scores each output stream and
un-scales predictions; invalid (NaN) entries are masked out of the
statistics."""

import numpy as np


class Normalizer:
    """Z-scorer for a single output stream."""

    def __init__(self, y=None):
        self.mean = 0.0
        self.std = 1.0
        if y is not None:
            self.fit(y)

    def fit(self, y):
        y = np.ma.masked_invalid(np.asarray(y, dtype=float))
        if y.count() == 0:
            raise ValueError("cannot normalize an all-invalid output")
        self.mean = float(y.mean())
        std = float(y.std())
        if std == 0.0:
            raise ValueError("cannot normalize a zero-variance output")
        self.std = std
        return self

    def normalize(self, y):
        return (np.asarray(y, dtype=float) - self.mean) / self.std

    def inverse_mean(self, mu):
        return np.asarray(mu) * self.std + self.mean

    def inverse_variance(self, var):
        return np.asarray(var) * self.std**2


class IdentityNormalizer:
    """No-op normalizer used when ``normalize=False``."""

    mean = 0.0
    std = 1.0

    def fit(self, y):
        return self

    def normalize(self, y):
        return np.asarray(y, dtype=float)

    def inverse_mean(self, mu):
        return np.asarray(mu)

    def inverse_variance(self, var):
        return np.asarray(var)
