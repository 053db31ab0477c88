"""The port's history files and plots (``utils/io.py``, ``utils/plotting.py``) against the JAX package's.

- ``save_history`` / ``load_history`` and the CSV pair round-trip a
  history dict like ``ClosedLoop.run``'s (vectors, scalars per step, a
  ragged key, an empty key).
- The same dict saved by each package reads back the same through either:
  the same keys, arrays (bit for bit) and meta.
- ``plot_history`` writes the same file names as JAX's, for a controlled
  and an estimation-only history (skips without matplotlib).

Numpy only on the port's side; about 3 s on the CPU.
"""

import importlib.util
import os

import numpy as np
import pytest

from mpc_code_tpu.utils import io as jio
from mpc_code_tpu_torch.utils import io as pio


def _history(n=6):
    rng = np.random.default_rng(0)
    return {"U": rng.normal(size=(n, 2)), "Yp": rng.normal(size=(n, 3)),
            "X_HAT": rng.normal(size=(n, 3)), "XS": rng.normal(size=(n, 3)),
            "US": rng.normal(size=(n, 2)), "YS": rng.normal(size=(n, 3)),
            "Xp": rng.normal(size=(n, 3)), "Y_HAT": rng.normal(size=(n, 3)),
            "D_HAT": rng.normal(size=(n, 2)), "STATUS_SS": np.zeros(n, dtype=np.int64),
            "TIME_DYN": rng.uniform(size=n), "LAMBDA": rng.normal(size=(n - 2, 3, 2)),
            "Sl": np.zeros((0,))}


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_npz_round_trip(tmp_path):
    H = _history()
    path = str(tmp_path / "h.npz")
    pio.save_history(path, H, h=0.5, name="x")
    got, meta = pio.load_history(path)
    _same(got, H)
    assert float(meta["h"]) == 0.5 and str(meta["name"]) == "x"


def test_csv_round_trip(tmp_path):
    H = {k: v for k, v in _history().items() if k not in ("Sl", "LAMBDA")}
    path = str(tmp_path / "h.csv")
    pio.save_history_csv(path, H)
    got = pio.load_history_csv(path)
    assert set(got) == set(H)
    for k in H:
        np.testing.assert_allclose(got[k], np.asarray(H[k], float), rtol=1e-15, err_msg=k)
    with pytest.raises(ValueError, match="empty"):
        pio.save_history_csv(str(tmp_path / "e.csv"), {"Sl": np.zeros((0,))})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_read_the_same_in_both_packages(tmp_path, writer):
    H = _history()
    save = (pio if writer == "port" else jio).save_history
    path = str(tmp_path / "h.npz")
    save(path, H, h=2.0)
    (gp, mp), (gj, mj) = pio.load_history(path), jio.load_history(path)
    _same(gp, gj)
    _same(mp, mj)
    csv_p, csv_j = str(tmp_path / "p.csv"), str(tmp_path / "j.csv")
    ragged = {k: v for k, v in H.items() if k != "Sl"}
    ragged["LAMBDA"] = ragged["LAMBDA"].reshape(len(ragged["LAMBDA"]), -1)
    pio.save_history_csv(csv_p, ragged)
    jio.save_history_csv(csv_j, ragged)
    assert open(csv_p).read() == open(csv_j).read()
    _same(pio.load_history_csv(csv_j), jio.load_history_csv(csv_p))


@pytest.mark.skipif(importlib.util.find_spec("matplotlib") is None,
                    reason="matplotlib is not installed")
@pytest.mark.parametrize("estimating", [False, True])
def test_plot_history_writes_the_same_files(tmp_path, estimating):
    from mpc_code_tpu.utils.plotting import plot_history as jplot
    from mpc_code_tpu_torch.utils.plotting import plot_history as pplot

    H = _history()
    H["Ysp"] = np.ones((6, 3))
    if estimating:
        H["X_KF"] = H["X_HAT"] + 0.1
    pplot(H, 0.5, str(tmp_path / "port") + "/", estimating=estimating)
    jplot(H, 0.5, str(tmp_path / "jax") + "/", estimating=estimating)
    port, ref = (sorted(os.listdir(tmp_path / d)) for d in ("port", "jax"))
    assert port == ref and len(port) >= 10
