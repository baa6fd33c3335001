"""Multi-output GP base model: validation, normalization, prediction
plumbing (host numpy copy of runlmc_tpu/models/multigp.py)."""

import numpy as np
import scipy.stats

from runlmc_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_model,
    save_checkpoint,
)
from runlmc_tpu_torch.utils.normalizer import IdentityNormalizer, Normalizer


class MultiGP:
    """Base class for multi-output GP models over ragged per-output data.

    :param Xs: list (length D) of per-output inputs, each (n_d,) or
        (n_d, P)
    :param Ys: list of per-output observations, each (n_d,)
    :param normalize: z-score each output
    """

    def __init__(self, Xs, Ys, normalize=True, name="multigp"):
        self.name = name
        self.input_dim, self.output_dim = self._validate_io(Xs, Ys)
        self.Xs = self._pad_dims(Xs)

        if normalize:
            self.normalizer = [Normalizer(Y) for Y in Ys]
        else:
            self.normalizer = [IdentityNormalizer() for _ in Ys]
        self.Ys = [
            norm.normalize(Y) for norm, Y in zip(self.normalizer, Ys)
        ]

    @staticmethod
    def _validate_io(Xs, Ys):
        """Check the ragged multi-output data lists are mutually
        consistent; returns ``(input_dim, output_dim)``.

        Reference quirk, matched on purpose: a constant output is
        rejected even when ``normalize=False``, where nothing would
        z-score it (runlmc_tpu/models/multigp.py:73-77)."""
        if not len(Xs):
            raise ValueError("Expecting at least 1 output")
        if len(Xs) != len(Ys):
            raise ValueError(
                "got {} input lists but {} observation lists".format(
                    len(Xs), len(Ys)
                )
            )
        dims = set()
        for i, (X, Y) in enumerate(zip(Xs, Ys)):
            X, Y = np.asarray(X), np.asarray(Y)
            if X.ndim not in (1, 2):
                raise ValueError(
                    "input {} has shape {}; expected 1-D or 2-D".format(
                        i, X.shape
                    )
                )
            if Y.ndim != 1:
                raise ValueError(
                    "observations {} have shape {}; expected 1-D".format(
                        i, Y.shape
                    )
                )
            if len(X) != len(Y):
                raise ValueError(
                    "output {}: {} inputs vs {} observations".format(
                        i, len(X), len(Y)
                    )
                )
            if len(Y) and np.std(Y) == 0:
                raise ValueError(
                    "output {} is constant (std dev 0); it cannot be "
                    "z-scored or meaningfully fit".format(i)
                )
            dims.add(X.shape[1] if X.ndim == 2 else 1)
        if len(dims) != 1:
            raise ValueError(
                "inputs have inconsistent dimensions {}".format(
                    sorted(dims)
                )
            )
        return dims.pop(), len(Xs)

    def _pad_dims(self, Xs):
        Xs = [
            np.asarray(X, dtype=float).reshape(-1, 1)
            if np.asarray(X).ndim == 1
            else np.asarray(X, dtype=float)
            for X in Xs
        ]
        for i, X in enumerate(Xs):
            if X.shape[1] != self.input_dim:
                raise ValueError(
                    "input {} dim {} != expected dim {}".format(
                        i, X.shape[1], self.input_dim
                    )
                )
        return Xs

    def log_likelihood(self):
        raise NotImplementedError

    def _raw_predict(self, Xs):
        """-> (means, vars): lists of per-output arrays in normalized
        space."""
        raise NotImplementedError

    def optimize(self, **kwargs):
        raise NotImplementedError

    def save(self, path, opt_state=None, extra=None):
        """Write a single-file ``.npz`` checkpoint (parameters, normalizer
        stats, optional optimizer state / extras, and the port's own
        run-seed, escalation and prior state), which the JAX package's
        ``load_checkpoint`` reads too (parity: multigp.py:119-125). See
        :mod:`runlmc_tpu_torch.utils.checkpoint`."""
        save_checkpoint(path, self, opt_state=opt_state, extra=extra)

    def restore(self, path):
        """Restore the model from a checkpoint written by :meth:`save`
        (or by the JAX package's); returns the loaded dict, whose
        ``opt_state`` resumes training through ``optimize(state=...)``
        (parity: multigp.py:127-141)."""
        ckpt = load_checkpoint(path)
        restore_model(self, ckpt)
        return ckpt

    def _predict(self, Xs, normalize):
        if len(Xs) != self.output_dim:
            raise ValueError(
                "expected {} test input lists, got {}".format(
                    self.output_dim, len(Xs)
                )
            )
        mu, var = self._raw_predict(Xs)
        if normalize:
            mu = [
                norm.inverse_mean(m)
                for norm, m in zip(self.normalizer, mu)
            ]
            var = [
                norm.inverse_variance(v)
                for norm, v in zip(self.normalizer, var)
            ]
        return mu, var

    def predict(self, Xs):
        """Posterior mean/variance per output at new inputs ``Xs`` (list
        of per-output arrays; empty arrays allowed)."""
        Xs = self._pad_dims(Xs)
        return self._predict(Xs, normalize=True)

    def predict_quantiles(self, Xs, quantiles=(2.5, 97.5)):
        """Gaussian predictive quantiles."""
        Xs = self._pad_dims(Xs)
        mu, var = self._predict(Xs, normalize=False)
        quantiles = np.fromiter(quantiles, dtype=float)
        out = [
            np.outer(np.sqrt(v), scipy.stats.norm.ppf(quantiles / 100.0))
            + m[:, np.newaxis]
            for m, v in zip(mu, var)
        ]
        return [
            norm.inverse_mean(q) for norm, q in zip(self.normalizer, out)
        ]
