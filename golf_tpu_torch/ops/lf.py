"""Transformed Liljencrants-Fant (LF) glottal-flow model.

Table construction is host-side numpy (it happens once at module build time
and the result is a static constant shipped to the device), mirroring the
two reference variants:

* v1: per-Rd scalar Newton solves (reference ``get_transformed_lf``,
  ``models/utils.py:308-360``)
* v2: vectorized closed-form-ish construction (reference
  ``get_transformed_lf_v2``, ``models/utils.py:363-400``)
"""

from __future__ import annotations

import math

import numpy as np


def rd_to_r_params(rd: np.ndarray):
    """Rd -> (Ra, Rk, Rg) regression (Fant 1994)."""
    rd = np.asarray(rd, dtype=np.float64)
    ra = -0.01 + 0.048 * rd
    rk = 0.224 + 0.118 * rd
    rg = (rk / 4) * (0.5 + 1.2 * rk) / (0.11 * rd - ra * (0.5 + 1.2 * rk))
    return ra, rk, rg


def transformed_lf(r_d: float = 0.3, t_0: float = 5.0, n_iter_eps: int = 5,
                   n_iter_a: int = 100, points: int = 1000) -> np.ndarray:
    """Scalar LF derivative pulse over one period (v1 Newton solver)."""
    r_ap = 0.048 * r_d - 0.01
    r_kp = 0.118 * r_d + 0.224
    r_gp = (0.25 * r_kp * (0.5 + 1.2 * r_kp)
            / (0.11 * r_d - r_ap * (0.5 + 1.2 * r_kp)))

    t_a = r_ap * t_0
    t_p = 0.5 * t_0 / r_gp
    t_e = t_p * (r_kp + 1)
    t_b = t_0 - t_e

    omega_g = math.pi / t_p
    e_e = 1.0

    a = 1.0
    eps = 1.0
    for _ in range(n_iter_eps):
        f_eps = eps * t_a + math.expm1(-eps * t_b)
        f_eps_grad = t_a - t_b * math.exp(-eps * t_b)
        eps = eps - f_eps / f_eps_grad
        eps = abs(eps)

    e_0 = 0.0
    for _ in range(n_iter_a):
        e_0 = -e_e * math.exp(-a * t_e) / math.sin(omega_g * t_e)
        a_o = (e_0 * math.exp(a * t_e) / math.sqrt(omega_g ** 2 + a ** 2)
               * math.sin(omega_g * t_e - math.atan(omega_g / a))
               + e_0 * omega_g / (omega_g ** 2 + a ** 2))
        a_r = (-e_e / (eps ** 2 * t_a)
               * (1 - math.exp(-eps * t_b) * (1 + eps * t_b)))
        f_a = a_o + a_r
        f_a_grad = ((1 - 2 * a * a_r / e_e) * math.sin(omega_g * t_e)
                    - omega_g * t_e * math.exp(-a * t_e))
        a = a - f_a / f_a_grad

    t = np.linspace(0, t_0, points + 1)[:-1]
    before = e_0 * np.exp(a * t) * np.sin(omega_g * t)
    after = (-e_e / eps / t_a
             * (np.exp(-eps * (t - t_e)) - math.exp(-eps * t_b)))
    return np.where(t < t_e, before, after)


def transformed_lf_v2(rd: np.ndarray, points: int = 1024) -> np.ndarray:
    """Vectorized LF derivative pulses, one period, unit time base.

    rd: (n,) -> (n, points). Mirrors reference v2 math exactly.
    """
    rd = np.asarray(rd, dtype=np.float64).reshape(-1, 1)
    ra, rk, rg = rd * 0.048 - 0.01, 0.224 + 0.118 * rd, None
    ra = -0.01 + 0.048 * rd
    rk = 0.224 + 0.118 * rd
    rg = (rk / 4) * (0.5 + 1.2 * rk) / (0.11 * rd - ra * (0.5 + 1.2 * rk))

    ta = ra
    tp = 1.0 / (2 * rg)
    te = tp + tp * rk

    epsilon = 1.0 / ta
    shift = np.exp(-epsilon * (1 - te))
    delta = 1 - shift

    rhs_integral = ((1 / epsilon) * (shift - 1) + (1 - te) * shift) / delta
    lower_integral = -(te - tp) / 2 + rhs_integral
    upper_integral = -lower_integral

    omega = np.pi / tp
    s = np.sin(omega * te)
    y = -np.pi * s * upper_integral / (tp * 2)
    z = np.log(y)
    alpha = z / (tp / 2 - te)
    e0 = -1 / (s * np.exp(alpha * te))

    t = np.linspace(0, 1, points + 1)[None, :-1]
    before = e0 * np.exp(alpha * t) * np.sin(omega * t)
    after = (-np.exp(-epsilon * (t - te)) + shift) / delta
    out = np.where(t < te, before, after)
    return np.squeeze(out)


def build_glottal_table(table_size: int = 100, table_type: str = "derivative",
                        normalize_method: str | None = "constant_power",
                        align_peak: bool = True, min_R_d: float = 0.3,
                        max_R_d: float = 2.7, lf_v2: bool = False,
                        **kwargs) -> np.ndarray:
    """Full table construction pipeline (reference ``GlottalFlowTable.__init__``,
    ``models/synth.py:58-121``): log-spaced Rd grid, optional cumsum to flow,
    peak alignment by roll, normalization."""
    rds = np.exp(np.linspace(math.log(min_R_d), math.log(max_R_d), table_size))
    if lf_v2:
        table = transformed_lf_v2(rds, **kwargs)
    else:
        table = np.stack([transformed_lf(r_d=r, **kwargs) for r in rds])

    if table_type == "flow":
        table = np.cumsum(table, axis=1)
    elif table_type != "derivative":
        raise ValueError(f"unknown table_type: {table_type}")

    if align_peak:
        peak_pos = (np.argmin(table, axis=1) if table_type == "derivative"
                    else np.argmax(table, axis=1))
        align_pos = int(peak_pos.max())
        table = np.stack([
            np.roll(table[i], align_pos - int(peak_pos[i]))
            for i in range(table.shape[0])])

    if normalize_method == "constant_power":
        table = (table / np.linalg.norm(table, axis=1, keepdims=True)
                 * math.sqrt(table.shape[1]))
    elif normalize_method == "peak":
        if table_type == "flow":
            table = table / table.max(axis=1, keepdims=True)
    elif normalize_method is not None:
        raise ValueError(f"unknown normalize_method: {normalize_method}")
    return table.astype(np.float32)
