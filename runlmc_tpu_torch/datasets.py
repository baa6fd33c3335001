"""In-repo synthetic problems shaped like the JAX package's benchmarks,
the benchmarks' file loaders and the toy problem.

The real fx2007, weather and synth files are read from a data directory
outside the repository (runlmc_tpu/datasets.py), so the port's
end-to-end checks use :func:`fx2007_synthetic`, :func:`weather_synthetic`
and :func:`synth_synthetic`: the same layouts, made from a seed with
numpy. Their quality numbers are no bar for the real data's.
:func:`fx2007`, :func:`weather` and :func:`synth` read the real files
where they are present (``datadir`` or the ``RUNLMC_DATA`` environment
variable), with numpy's and the standard library's readers in place of
pandas, which the machine with the card lacks; :func:`toy_sinusoid`
reads no file.
"""

import csv
import os

import numpy as np

# the cells that pandas' read_csv reads as missing by default
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
       "n/a", "nan", "null"}


# The data directory when neither ``datadir`` nor ``RUNLMC_DATA`` names
# one: none, since the reference's data files are not in the repository
# (the JAX package's default names a checkout outside it).
DEFAULT_DATA_DIR = None


def _data_dir(datadir, what):
    datadir = datadir or os.environ.get("RUNLMC_DATA", DEFAULT_DATA_DIR)
    if not datadir:
        raise ValueError("%s: pass datadir or set RUNLMC_DATA to the "
                         "reference's data directory" % what)
    return datadir


def _cell(v):
    v = v.strip()
    return np.nan if v in _NA else float(v)


def fx2007(datadir=None):
    """Foreign-exchange 2007 benchmark (parity: runlmc_tpu/datasets.py:
    18-58): D=13 currency outputs over the 2007 trading days of
    ``<datadir>/fx/{2007-2009,2010-2013,2014-2017}.csv`` (the second
    column the date, YYYY/MM/DD; ``Wdy`` and ``Jul.Day`` dropped; each
    currency named by its first three letters), the model's target
    1 / (currency per USD), missing days dropped, CAD/JPY/AUD with
    held-out 50-day windows. Returns (xss, yss, test_xss, test_yss,
    test_cols, cols)."""
    datadir = _data_dir(datadir, "fx2007")
    header, dates, rows = None, [], []
    for f in ["2007-2009.csv", "2010-2013.csv", "2014-2017.csv"]:
        with open(os.path.join(datadir, "fx", f), newline="") as fh:
            reader = csv.reader(fh)
            head = next(reader)
            if header is None:
                header = head
            elif head != header:
                raise ValueError("fx2007: %s has other columns" % f)
            for r in reader:
                if r:
                    dates.append(r[1])
                    rows.append(r)
    keep_cols = [i for i, c in enumerate(header)
                 if i != 1 and c not in ("Wdy", "Jul.Day")]
    cols = [header[i][:3] for i in keep_cols]
    sel_rows = [k for k, d in enumerate(dates)
                if "2007/01/01" <= d <= "2008/01/01"]
    values = np.array([[_cell(rows[k][i]) for i in keep_cols]
                       for k in sel_rows]).reshape(len(sel_rows), len(cols))
    holdout = {"CAD": slice(49, 99), "JPY": slice(99, 149),
               "AUD": slice(149, 199)}
    all_ixs = np.arange(len(sel_rows))
    xss, yss, test_xss, test_yss = [], [], [], []
    for j, col in enumerate(cols):
        hold = holdout.get(col, slice(0, 0))
        keep = ~np.isnan(values[:, j])
        keep[hold] = False
        sel = np.flatnonzero(keep)
        xss.append(all_ixs[sel].astype(float))
        yss.append(np.reciprocal(values[sel, j]))
        test_xss.append(all_ixs[hold].astype(float))
        test_yss.append(np.reciprocal(values[hold, j]))
    return xss, yss, test_xss, test_yss, ["CAD", "JPY", "AUD"], cols


def weather(datadir=None):
    """Weather-sensor benchmark (parity: runlmc_tpu/datasets.py:61-92):
    the air temperature (4th column, -1 meaning missing) of four sensors
    from ``<datadir>/weather/<s>y.csv`` against the times of
    ``<s>x.csv``, row by row where both exist, missing readings dropped,
    with held-out windows for 'cam' and 'chi'. Returns (xss, yss,
    test_xss, test_yss, sensors)."""
    datadir = _data_dir(datadir, "weather")
    sensors = ["bra", "cam", "chi", "sot"]
    holdout = [None, (10.2, 10.8), (13.5, 14.2), None]
    xss, yss, test_xss, test_yss = [], [], [], []
    for sensor, hold in zip(sensors, holdout):
        base = os.path.join(datadir, "weather", sensor)
        with open(base + "y.csv", newline="") as fh:
            atmp = np.array([_cell(r[3]) for r in csv.reader(fh) if r])
        with open(base + "x.csv", newline="") as fh:
            time = np.array([_cell(r[0]) for r in csv.reader(fh) if r])
        atmp[atmp == -1] = np.nan
        rows = np.flatnonzero(~np.isnan(atmp[:len(time)]))
        t, a = time[rows], atmp[rows]
        if hold is None:
            test_xss.append(np.array([]))
            test_yss.append(np.array([]))
            xss.append(t)
            yss.append(a)
        else:
            sel = (t >= hold[0]) & (t <= hold[1])
            test_xss.append(t[sel])
            test_yss.append(a[sel])
            xss.append(t[~sel])
            yss.append(a[~sel])
    return xss, yss, test_xss, test_yss, sensors


def toy_sinusoid(n=1500, seed=0):
    """2-output sin/-sin toy (parity: runlmc_tpu/datasets.py:111-119)."""
    rng = np.random.default_rng(seed)
    xss = [rng.uniform(-10, 10, size=n) for _ in range(2)]
    yss = [
        np.sin(xss[0]) + rng.standard_normal(n) * 1e-2,
        -np.sin(xss[1]) + rng.standard_normal(n) * 1e-2,
    ]
    return xss, yss

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


SYNTH_OUTPUTS = 5
SYNTH_POINTS = 10_000  # per output, before the held-out quadrant


def _synth_split(xss, yss):
    """The synth benchmark's split (parity: runlmc_tpu/datasets.py:
    95-108): the last output's points with both coordinates >= 0.5 are
    the test set; every other output keeps all of its points."""
    xss, yss = list(xss), list(yss)
    sel = np.all(xss[-1] >= 0.5, axis=1)
    e2 = np.zeros((0, 2))
    test_xss = [e2] * (len(xss) - 1) + [xss[-1][sel]]
    test_yss = ([np.zeros(0)] * (len(xss) - 1)
                + [np.asarray(yss[-1]).ravel()[sel]])
    xss[-1] = xss[-1][~sel, :]
    yss[-1] = np.asarray(yss[-1]).ravel()[~sel]
    yss[:-1] = [np.asarray(y).ravel() for y in yss[:-1]]
    return xss, yss, test_xss, test_yss


def synth(datadir=None):
    """The synthetic D=5, P=2 benchmark of the reference, from
    ``<datadir>/synth/xss.npy`` and ``yss.npy`` (``datadir`` defaults to
    the ``RUNLMC_DATA`` environment variable); the last output's
    upper-right quadrant is held out. Returns (xss, yss, test_xss,
    test_yss)."""
    datadir = _data_dir(datadir, "synth")
    xss = list(np.load(os.path.join(datadir, "synth", "xss.npy")))
    yss = list(np.load(os.path.join(datadir, "synth", "yss.npy")))
    return _synth_split(xss, yss)


def synth_synthetic(seed=0):
    """A SYNTHETIC problem in the layout of the synth benchmark
    (bench.py:114-130, runlmc_tpu/datasets.py:95-108): D = 5 outputs of
    10,000 points each, uniform on [0, 1]^2; each output mixes two smooth
    shared latent fields with a smooth field of its own, plus noise; the
    last output's quadrant x >= 0.5 (both coordinates, about 2,500
    points) is the test set, leaving n of about 47,500. Returns (xss,
    yss, test_xss, test_yss)."""
    rng = np.random.RandomState(seed)

    def field(x):
        """A sum of three plane waves of wavelength 0.5 to 2."""
        out = np.zeros(len(x))
        for _ in range(3):
            angle = rng.uniform(0, 2 * np.pi)
            freq = rng.uniform(0.5, 2.0)
            wave = freq * np.array([np.cos(angle), np.sin(angle)])
            out += rng.uniform(0.3, 1.0) * np.sin(
                2 * np.pi * (x @ wave) + rng.uniform(0, 2 * np.pi))
        return out

    xss = [rng.uniform(0, 1, (SYNTH_POINTS, 2))
           for _ in range(SYNTH_OUTPUTS)]
    x_all = np.concatenate(xss)
    shared = [field(x_all) for _ in range(2)]
    mix = rng.standard_normal((SYNTH_OUTPUTS, 2))
    yss = []
    for d, x in enumerate(xss):
        rows = slice(d * SYNTH_POINTS, (d + 1) * SYNTH_POINTS)
        yss.append(mix[d, 0] * shared[0][rows] + mix[d, 1] * shared[1][rows]
                   + 0.3 * field(x) + 0.05 * rng.standard_normal(len(x)))
    return _synth_split(xss, yss)
