"""History files (port of ``mpc_code_tpu/utils/io.py``, a copy: numpy only).

The reference keeps all closed-loop history in Python lists and loses
everything on a crash (SURVEY.md §5 checkpoint/resume: none).  Here history
and loop state serialize to a single NPZ (or CSV) so long Nsim sweeps are
resumable and the files double as golden parity fixtures.  The formats
are the JAX package's, so either package reads the other's files.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def save_history(path: str, H: Dict[str, np.ndarray], **meta):
    """Write history arrays (+ scalar metadata) to an .npz file."""
    payload = {f"H_{k}": np.asarray(v) for k, v in H.items()}
    for k, v in meta.items():
        payload[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_history(path: str):
    """Returns (history_dict, meta_dict)."""
    data = np.load(path, allow_pickle=False)
    H = {k[2:]: data[k] for k in data.files if k.startswith("H_")}
    meta = {k[5:]: data[k] for k in data.files if k.startswith("meta_")}
    return H, meta


def save_history_csv(path: str, H: Dict[str, np.ndarray]):
    """Write history arrays to one CSV (SURVEY.md §5 metrics export).

    Columns are ``<key>_<i>`` per vector component, one row per step;
    scalar-per-step keys get a single column.  Ragged keys (different
    number of steps, e.g. adaptation-only arrays) are padded with NaN.
    """
    import csv

    def to2d(v):
        a = np.asarray(v, dtype=float)
        return a[:, None] if a.ndim == 1 else a

    arrays = {k: to2d(v) for k, v in H.items() if np.asarray(v).size}
    if not arrays:
        raise ValueError("empty history")
    n = max(a.shape[0] for a in arrays.values())
    cols, names = [], []
    for k in sorted(arrays):
        a = arrays[k]
        if a.ndim > 2:
            a = a.reshape(a.shape[0], -1)
        if a.shape[0] < n:
            a = np.vstack([a, np.full((n - a.shape[0], a.shape[1]), np.nan)])
        for i in range(a.shape[1]):
            names.append(k if a.shape[1] == 1 else f"{k}_{i}")
            cols.append(a[:, i])
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(names)
        w.writerows(zip(*cols))


def load_history_csv(path: str) -> Dict[str, np.ndarray]:
    """Inverse of :func:`save_history_csv` (components re-grouped by key)."""
    import csv

    with open(path, newline="") as f:
        r = csv.reader(f)
        names = next(r)
        rows = [[float(x) for x in row] for row in r]
    data = np.asarray(rows)
    H: Dict[str, list] = {}
    order: Dict[str, list] = {}
    for j, name in enumerate(names):
        base, _, idx = name.rpartition("_")
        if idx.isdigit() and base:
            order.setdefault(base, []).append((int(idx), j))
        else:
            order.setdefault(name, []).append((0, j))
    for key, pairs in order.items():
        pairs.sort()
        cols = data[:, [j for _, j in pairs]]
        H[key] = cols[:, 0] if len(pairs) == 1 else cols
    return H
