"""Analytic multi-fidelity benchmark functions (counterpart of
``dgp_tpu/utils/test_functions.py``; numpy only, so this is the same code,
kept here so that the port imports nothing of the JAX package): the Park
pair on [0,1]^4, the variant-input-dimension Park_VD pair (low fidelity on
[0,1]^2, high on [0,1]^4, extra coordinates pinned to 0.5 in the
low-fidelity coupling), the borehole, Branin and Forrester pairs, the
nonlinear pair f_high = f_low^2 (NARGP's test case), and the r2 / rmse /
mnll metrics.
"""

from __future__ import annotations

import numpy as np


def park_high(x):
    """Park function, x in [0,1]^4 -> [n, 1]."""
    x = np.asarray(x)
    x1 = np.maximum(x[:, 0], 1e-8)
    x2, x3, x4 = x[:, 1], x[:, 2], x[:, 3]
    ret = (x1 / 2) * (np.sqrt(1 + (x2 + x3**2) * x4 / x1**2) - 1)
    ret += (x1 + 3 * x4) * np.exp(1 + np.sin(x3))
    return ret[:, None]


def park_low(x):
    """Low-fidelity Park (emukit convention)."""
    x = np.asarray(x)
    x1, x2, x3 = x[:, 0], x[:, 1], x[:, 2]
    ret = (1 + np.sin(x1) / 10) * park_high(x)[:, 0] - 2 * x1 + x2**2 + x3**2 + 0.5
    return ret[:, None]


def park_vd_high(x):
    """Park_VD high fidelity on [0,1]^4 (nb_mfdgpem cell 4 index convention:
    x2 <- x[:,2], x3 <- x[:,1])."""
    x = np.asarray(x)
    x1 = np.maximum(x[:, 0], 1e-8)
    x2, x3, x4 = x[:, 2], x[:, 1], x[:, 3]
    tmp = 1 + (x2 + x3) * (x4 / x1**2)
    return ((x1 / 2) * (np.sqrt(tmp) - 1) + (x1 + 3 * x4) * np.exp(1 + np.sin(x3)))[
        :, None
    ]


def park_vd_low(x):
    """Park_VD low fidelity on [0,1]^2: couples to the high function with the
    missing coordinates pinned at 0.5."""
    x = np.asarray(x)
    f_high = park_vd_high(
        np.concatenate((x, 0.5 * np.ones((x.shape[0], 2))), axis=1)
    )
    x1, x2 = x[:, 0], x[:, 1]
    return ((1 + np.sin(x1) / 10) * f_high[:, 0] - 2 * x1 + x2**2 + 0.5**2 + 0.5)[
        :, None
    ]


#: Physical borehole domain, one (lo, hi) per input: r_w, r, T_u, H_u,
#: T_l, H_l, L, K_w (Harper & Gupta 1983; the MF low fidelity is Xiong,
#: Qian & Wu 2013). Functions below take the unit box and rescale.
_BOREHOLE_BOUNDS = np.array(
    [(0.05, 0.15), (100.0, 50000.0), (63070.0, 115600.0), (990.0, 1110.0),
     (63.1, 116.0), (700.0, 820.0), (1120.0, 1680.0), (9855.0, 12045.0)])


def _borehole_terms(x):
    x = np.asarray(x, dtype=float)
    lo, hi = _BOREHOLE_BOUNDS[:, 0], _BOREHOLE_BOUNDS[:, 1]
    z = lo + (hi - lo) * x
    r_w, r, T_u, H_u, T_l, H_l, L, K_w = (z[:, i] for i in range(8))
    log_rr = np.log(r / r_w)
    frac = 2.0 * L * T_u / (log_rr * r_w**2 * K_w)
    return T_u * (H_u - H_l), log_rr, frac, T_u / T_l


def borehole_high(x):
    """Borehole water-flow function on the unit box [0,1]^8 -> [n, 1]
    (m^3/yr through a borehole; the standard 8-D emulation benchmark)."""
    num, log_rr, frac, ratio = _borehole_terms(x)
    return (2.0 * np.pi * num / (log_rr * (1.0 + frac + ratio)))[:, None]


def borehole_low(x):
    """Low-fidelity borehole (Xiong, Qian & Wu 2013): the 2*pi factor
    drops to 5 and the denominator constant 1 becomes 1.5 — a global
    scale + shape distortion, the classic 8-D MF benchmark pair."""
    num, log_rr, frac, ratio = _borehole_terms(x)
    return (5.0 * num / (log_rr * (1.5 + frac + ratio)))[:, None]


def branin_high(x):
    """Branin-Hoo on the unit box [0,1]^2 -> [n, 1] (physical domain
    [-5, 10] x [0, 15]; three global minima at 0.397887)."""
    x = np.asarray(x, dtype=float)
    x1 = -5.0 + 15.0 * x[:, 0]
    x2 = 15.0 * x[:, 1]
    a, b, c = 1.0, 5.1 / (4 * np.pi**2), 5.0 / np.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * np.pi)
    return (a * (x2 - b * x1**2 + c * x1 - r) ** 2
            + s * (1 - t) * np.cos(x1) + s)[:, None]


def branin_low(x):
    """Nonlinear low-fidelity branin (Perdikaris et al. 2017, NARGP):
    10*sqrt(f_high) + 2(x1-0.5) - 3(3x2-1) - 1 in unit-box coords — the
    low fidelity is a NONLINEAR transform of the high one, the canonical
    stress case for linear-autoregressive (AR1) multi-fidelity models."""
    x = np.asarray(x, dtype=float)
    return (10.0 * np.sqrt(branin_high(x)[:, 0])
            + 2.0 * (x[:, 0] - 0.5) - 3.0 * (3.0 * x[:, 1] - 1.0) - 1.0)[:, None]


def forrester_high(x):
    """Forrester et al. (2008) 1-D function, x in [0,1] -> [n, 1]; the
    canonical multi-fidelity BO demo (global minimum f(0.75725) = -6.0207)."""
    x = np.asarray(x).reshape(-1)
    return ((6 * x - 2) ** 2 * np.sin(12 * x - 4))[:, None]


def forrester_low(x):
    """Standard low-fidelity Forrester: 0.5*f(x) + 10(x - 0.5) - 5."""
    x = np.asarray(x).reshape(-1)
    return (0.5 * forrester_high(x)[:, 0] + 10 * (x - 0.5) - 5)[:, None]


def nonlinear_low(x):
    """sin(8 pi x), x in [0,1] -> [n, 1]: the low fidelity of the pair whose
    high fidelity is its square, a map no linear (AR(1)) coupling
    recovers."""
    return np.sin(8.0 * np.pi * np.asarray(x).reshape(-1, 1))


def nonlinear_high(x):
    """nonlinear_low(x)^2 -> [n, 1]."""
    return nonlinear_low(x) ** 2


def calculate_metrics(y_test, y_mean, y_var):
    """r2 / rmse / mnll as defined in nb_mfdgpem cell 7."""
    from scipy.stats import norm

    y_test = np.asarray(y_test).reshape(-1)
    y_mean = np.asarray(y_mean).reshape(-1)
    y_var = np.asarray(y_var).reshape(-1)
    ss_res = np.sum((y_test - y_mean) ** 2)
    ss_tot = np.sum((y_test - y_test.mean()) ** 2)
    r2 = 1 - ss_res / ss_tot
    rmse = float(np.sqrt(np.mean((y_test - y_mean) ** 2)))
    mnll = -float(
        np.sum(norm.logpdf(y_test, loc=y_mean, scale=np.sqrt(y_var)))
    ) / len(y_test)
    return {"r2": float(r2), "rmse": rmse, "mnll": mnll}
