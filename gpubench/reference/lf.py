"""The glottal-flow wavetable of GOLF, host numpy, float64 until the end.

The transformed Liljencrants-Fant (LF) derivative pulse over one period
(Fant 1995's Rd regression, the vectorised construction of the GOLF
repository's ``get_transformed_lf_v2``), on a log-spaced Rd grid, each
pulse rolled so that its negative peak sits where the latest one does, and
scaled to constant power.
"""

from __future__ import annotations

import math

import numpy as np


def lf_pulses(rd: np.ndarray, points: int) -> np.ndarray:
    """LF derivative pulses (n, points) for Rd values (n,), one period on
    a unit time base."""
    rd = np.asarray(rd, dtype=np.float64).reshape(-1, 1)
    ra = -0.01 + 0.048 * rd
    rk = 0.224 + 0.118 * rd
    rg = (rk / 4) * (0.5 + 1.2 * rk) / (0.11 * rd - ra * (0.5 + 1.2 * rk))
    ta = ra
    tp = 1.0 / (2 * rg)
    te = tp + tp * rk
    epsilon = 1.0 / ta
    shift = np.exp(-epsilon * (1 - te))
    delta = 1 - shift
    rhs = ((1 / epsilon) * (shift - 1) + (1 - te) * shift) / delta
    lower = -(te - tp) / 2 + rhs
    omega = np.pi / tp
    s = np.sin(omega * te)
    y = -np.pi * s * (-lower) / (tp * 2)
    alpha = np.log(y) / (tp / 2 - te)
    e0 = -1 / (s * np.exp(alpha * te))
    t = np.linspace(0, 1, points + 1)[None, :-1]
    before = e0 * np.exp(alpha * t) * np.sin(omega * t)
    after = (-np.exp(-epsilon * (t - te)) + shift) / delta
    return np.where(t < te, before, after)


def glottal_table(table_size: int = 100, points: int = 2048,
                  min_rd: float = 0.3, max_rd: float = 2.7) -> np.ndarray:
    """The derivative table (table_size, points), peak-aligned, constant
    power, float32."""
    rds = np.exp(np.linspace(math.log(min_rd), math.log(max_rd), table_size))
    table = lf_pulses(rds, points)
    peak = np.argmin(table, axis=1)
    align = int(peak.max())
    table = np.stack([np.roll(row, align - int(k))
                      for row, k in zip(table, peak)])
    table = table / np.linalg.norm(table, axis=1, keepdims=True) \
        * math.sqrt(points)
    return table.astype(np.float32)
