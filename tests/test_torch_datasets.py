"""The benchmarks' file loaders and the toy problem of the port
(``runlmc_tpu_torch.datasets``: numpy and the standard library's csv
reader) against the JAX package's (pandas), on tiny files written in
the reference's layout: the same arrays, to the last bit or one
rounding of the float parse."""

import numpy as np
import pytest

from runlmc_tpu import datasets as jdata
from runlmc_tpu_torch import datasets as tdata

FX_COLS = ["CAD/USD", "JPY/USD", "AUD/USD", "EUR/USD"]


def _fx_files(root, rng):
    """Three fx files: the first spans 2006-12 to 2008-01 (every day of
    2007 but weekends), the others a few later days; some cells empty or
    'NA'."""
    (root / "fx").mkdir()
    days = np.arange(np.datetime64("2006-12-20"), np.datetime64("2008-01-10"))
    per_file = {"2007-2009.csv": days,
                "2010-2013.csv": np.arange(np.datetime64("2010-01-04"),
                                           np.datetime64("2010-01-09")),
                "2014-2017.csv": np.arange(np.datetime64("2014-01-06"),
                                           np.datetime64("2014-01-08"))}
    for name, ds in per_file.items():
        lines = ["Wdy,YYYY/MM/DD,Jul.Day," + ",".join(FX_COLS)]
        for d in ds:
            wd = (d.astype("datetime64[D]").view("int64") - 4) % 7
            if wd >= 5:
                continue
            cells = []
            for c in range(len(FX_COLS)):
                u = rng.uniform()
                if u < 0.03:
                    cells.append("")
                elif u < 0.05:
                    cells.append("NA")
                else:
                    cells.append("%.4f" % rng.uniform(0.5, 150.0))
            lines.append("%s,%s,%d,%s" % (["Mon", "Tue", "Wed", "Thu",
                                           "Fri"][wd],
                                          str(d).replace("-", "/"),
                                          2454000 + int(d.view("int64")),
                                          ",".join(cells)))
        (root / "fx" / name).write_text("\n".join(lines) + "\n")


def _weather_files(root, rng):
    (root / "weather").mkdir()
    for k, s in enumerate(["bra", "cam", "chi", "sot"]):
        n = 300 + 10 * k
        t = np.sort(rng.uniform(9.5, 14.5, n))
        nx = n - 5 if s == "chi" else n  # fewer times than readings
        (root / "weather" / (s + "x.csv")).write_text(
            "\n".join("%.6f" % v for v in t[:nx]) + "\n")
        rows = []
        for i in range(n):
            u = rng.uniform()
            a = ("-1" if u < 0.05 else "" if u < 0.08
                 else "%.2f" % rng.uniform(5, 25))
            rows.append("%.1f,%d,%.1f,%s" % (rng.uniform(0, 10),
                                            rng.randint(360),
                                            rng.uniform(0, 15), a))
        (root / "weather" / (s + "y.csv")).write_text("\n".join(rows) + "\n")


def _same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if isinstance(w, (list, tuple)) and w and isinstance(w[0], str):
            assert list(w) == list(g)
            continue
        assert len(w) == len(g)
        for a, b in zip(w, g):
            a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
            assert a.shape == b.shape
            np.testing.assert_allclose(b, a, rtol=2.3e-16, atol=0)


def test_fx2007_loader_matches_jax(tmp_path, monkeypatch):
    _fx_files(tmp_path, np.random.RandomState(0))
    want = jdata.fx2007(datadir=str(tmp_path))
    got = tdata.fx2007(datadir=str(tmp_path))
    _same(want, got)
    assert got[4] == ["CAD", "JPY", "AUD"] and got[5] == ["CAD", "JPY",
                                                          "AUD", "EUR"]
    assert all(len(t) == 50 for t in got[2][:3]) and len(got[2][3]) == 0
    monkeypatch.setenv("RUNLMC_DATA", str(tmp_path))
    _same(want, tdata.fx2007())


def test_weather_loader_matches_jax(tmp_path):
    _weather_files(tmp_path, np.random.RandomState(1))
    want = jdata.weather(datadir=str(tmp_path))
    got = tdata.weather(datadir=str(tmp_path))
    _same(want, got)
    assert len(got[2][1]) > 0 and len(got[2][2]) > 0
    assert len(got[2][0]) == len(got[2][3]) == 0


def test_loaders_need_a_data_directory(monkeypatch):
    monkeypatch.delenv("RUNLMC_DATA", raising=False)
    for loader in (tdata.fx2007, tdata.weather, tdata.synth):
        with pytest.raises(ValueError):
            loader()


@pytest.mark.parametrize("n,seed", [(1500, 0), (40, 3)])
def test_toy_sinusoid_matches_jax(n, seed):
    want = jdata.toy_sinusoid(n=n, seed=seed)
    got = tdata.toy_sinusoid(n=n, seed=seed)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)
