"""In-repo synthetic problems shaped like the JAX package's benchmarks.

The real fx2007 and weather CSVs are read from outside the repository
(runlmc_tpu/datasets.py), so the port's end-to-end checks use
:func:`fx2007_synthetic` and :func:`weather_synthetic`: the same
layouts, made from a seed with numpy. Their quality numbers are no bar
for the real data's.
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


WEATHER_SENSORS = ("bra", "cam", "chi", "sot")
# held-out time windows in days, per sensor (runlmc_tpu/datasets.py:64)
WEATHER_HOLDOUT = (None, (10.2, 10.8), (13.5, 14.2), None)
WEATHER_POINTS = 4100  # readings per sensor before drops
WEATHER_STEP_DAYS = 5.0 / (24 * 60)  # 5-minute spacing
WEATHER_DROP_FRAC = 0.015  # share of readings lost, as the NaN ones are


def weather_synthetic(seed=0):
    """A SYNTHETIC problem shaped like the weather benchmark
    (runlmc_tpu/datasets.py:58-92): D = 4 air-temperature sensors read
    every 5 minutes over about 14 days (times in days), a random 1.5% of
    the readings dropped as the NaN ones are, and sensors 1 and 2 losing
    the windows (10.2, 10.8) and (13.5, 14.2) to the test set: n is about
    15.8k training points. Each sensor mixes two shared smooth latent
    processes (a daily cycle and a slow weather front) with a term of
    its own, plus noise. Returns (xss, yss, test_xss, test_yss,
    sensors)."""
    rng = np.random.RandomState(seed)
    x = 0.5 + WEATHER_STEP_DAYS * np.arange(WEATHER_POINTS)

    def smooth(periods):
        """A sum of sinusoids with the given periods (days)."""
        out = np.zeros_like(x)
        for p in periods:
            out += rng.uniform(0.3, 1.0) * np.sin(
                2 * np.pi * x / p + rng.uniform(0, 2 * np.pi))
        return out

    daily = smooth((1.0, 0.5))
    front = smooth((9.0, 4.3, 2.1))
    mix = rng.uniform(0.5, 1.5, size=(len(WEATHER_SENSORS), 2))
    base = rng.uniform(8.0, 16.0, size=len(WEATHER_SENSORS))
    xss, yss, test_xss, test_yss = [], [], [], []
    for d, hold in enumerate(WEATHER_HOLDOUT):
        own = smooth((1.7, 0.8))
        y = (base[d] + 3.0 * mix[d, 0] * daily + 2.0 * mix[d, 1] * front
             + 0.5 * own + 0.1 * rng.standard_normal(len(x)))
        keep = rng.uniform(size=len(x)) >= WEATHER_DROP_FRAC
        test = np.zeros(len(x), dtype=bool)
        if hold is not None:
            test = keep & (x >= hold[0]) & (x <= hold[1])
        train = keep & ~test
        xss.append(x[train])
        yss.append(y[train])
        test_xss.append(x[test])
        test_yss.append(y[test])
    return xss, yss, test_xss, test_yss, list(WEATHER_SENSORS)
