"""In-repo synthetic problems shaped like the JAX package's benchmarks.

The real fx2007 CSVs are read from outside the repository
(runlmc_tpu/datasets.py), so the port's end-to-end checks use
:func:`fx2007_synthetic`: the same layout, made from a seed with numpy.
"""

import numpy as np

FX2007_DAYS = 251
FX2007_OUTPUTS = 13
# outputs with a held-out 50-day window, and the windows
# (runlmc_tpu/datasets.py:34-38: CAD, JPY, AUD)
FX2007_HOLDOUT = {3: slice(49, 99), 5: slice(99, 149), 0: slice(149, 199)}


def fx2007_synthetic(seed=0):
    """A problem shaped like fx2007: 13 outputs over day indices
    0..250, three of which lose a 50-day window to the test set
    (n = 13 * 251 - 150 = 3113 training points, 150 test points).
    Each output is a random mix of two smooth shared latent curves plus
    noise. Returns (xss, yss, test_xss, test_yss)."""
    rng = np.random.RandomState(seed)
    x = np.arange(FX2007_DAYS, dtype=float)

    def latent():
        freqs = rng.uniform(0.005, 0.05, size=4)
        phases = rng.uniform(0, 2 * np.pi, size=4)
        amps = rng.uniform(0.2, 1.0, size=4)
        return sum(a * np.sin(2 * np.pi * f * x + p)
                   for a, f, p in zip(amps, freqs, phases))

    f1, f2 = latent(), latent()
    mix = rng.standard_normal((FX2007_OUTPUTS, 2))
    offsets = rng.uniform(0.5, 2.0, size=FX2007_OUTPUTS)
    xss, yss, test_xss, test_yss = [], [], [], []
    for d in range(FX2007_OUTPUTS):
        y = (offsets[d] + 0.1 * (mix[d, 0] * f1 + mix[d, 1] * f2)
             + 0.005 * rng.standard_normal(FX2007_DAYS))
        keep = np.ones(FX2007_DAYS, dtype=bool)
        hold = FX2007_HOLDOUT.get(d, slice(0, 0))
        keep[hold] = False
        xss.append(x[keep])
        yss.append(y[keep])
        test_xss.append(x[hold])
        test_yss.append(y[hold])
    return xss, yss, test_xss, test_yss
