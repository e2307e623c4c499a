"""Analytic multi-objective test problems (counterpart of
``dgp_tpu/bo/problems.py``; numpy only, so this is the same code, kept here
so that the port imports nothing of the JAX package).

The reference's problem suite (Kursawe, Deb, DTLZ and the 1-D problems;
the formulas are the specification) plus two constrained problems, as a
registry of ``MOProblem`` instances; each exposes ``bounds`` (L1, L2, U1,
U2 hypervolume reference box), ``dim``, ``hv_max`` and ``fun(x) -> [f1,
f2]``, and the constrained ones ``con(x)`` (<= 0 feasible).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Tuple

import numpy as np


@dataclass
class MOProblem:
    name: str
    dim: int
    bounds: Tuple[float, float, float, float]
    hv_max: float
    _fun: Callable = field(repr=False)
    #: inequality constraints g_i(x) <= 0 feasible, x in [0, 1]^dim — the
    #: same sign convention as the feasibility column (the NDC filter keeps
    #: rows with C.max() <= 0). Empty for the 8 unconstrained problems.
    cons: Tuple[Callable, ...] = ()

    def fun(self, x):
        return self._fun(np.asarray(x))

    @property
    def n_con(self) -> int:
        return len(self.cons)

    def con(self, x):
        """[n_con] constraint values at one point (<= 0 feasible)."""
        x = np.asarray(x)
        return [float(np.reshape(g(x), ())) for g in self.cons]


def _osc(x):
    """The oscillatory factor shared by the 1-D problems."""
    return np.cos(15 * (2 * x - 0.2))


def _f_1d(x):
    return [-x * _osc(x), x**2 * np.exp(_osc(x)) - 1]


def _f_1d_2(x):
    return [-np.cos(15 * x), -x * np.exp(_osc(x)) - 1]


def _f_1d_3(x):
    f1 = -((6 * x - 2) ** 2) * np.sin(12 * x - 4)
    return [f1, -(0.5 * f1 + 10 * (x - 0.5) + 5)]


def _f_1d_4(x):
    e = np.exp(_osc(x))
    return [e - 1, -x * e - 1]


def _f_kursawe(x):
    z = 10 * x - 5
    f1 = np.sum(-10 * np.exp(-0.2 * np.sqrt(z[:-1] ** 2 + z[1:] ** 2)))
    f2 = np.sum(np.abs(z) ** 0.8 + 5 * np.sin(z**3))
    return [f1, f2]


def _f_deb6(x):
    f1 = 1 - np.exp(-4 * x[0]) * np.sin(6 * np.pi * x[0]) ** 6
    g = 1 + 9 * (np.abs(np.sum(x[1:])) / 9) ** 0.25
    return [f1, g * (1 - (f1 / g) ** 2)]


def _f_dtlz1a(x):
    g = 100 * (5 + np.sum((x[1:] - 0.5) ** 2 - np.cos(2 * np.pi * (x[1:] - 0.5))))
    return [-0.5 * x[1] * (1 + g), -0.5 * (1 - x[1]) * (1 + g)]


# -- constrained bi-objective problems (beyond reference: the reference's
# registry is unconstrained; these are the standard constrained test
# problems of Binh & Korn (1997) and Srinivas & Deb (1994), mapped onto the
# [0, 1]^2 design domain like every other registry problem) -------------------


def _bnh_xy(x):
    return 5.0 * x[0], 3.0 * x[1]


def _f_bnh(x):
    x1, x2 = _bnh_xy(x)
    return [4 * x1**2 + 4 * x2**2, (x1 - 5) ** 2 + (x2 - 5) ** 2]


def _g_bnh_1(x):
    x1, x2 = _bnh_xy(x)
    return (x1 - 5) ** 2 + x2**2 - 25.0


def _g_bnh_2(x):
    x1, x2 = _bnh_xy(x)
    return 7.7 - (x1 - 8) ** 2 - (x2 + 3) ** 2


def _srn_xy(x):
    return 40.0 * x[0] - 20.0, 40.0 * x[1] - 20.0


def _f_srn(x):
    x1, x2 = _srn_xy(x)
    return [(x1 - 2) ** 2 + (x2 - 1) ** 2 + 2, 9 * x1 - (x2 - 1) ** 2]


def _g_srn_1(x):
    x1, x2 = _srn_xy(x)
    return x1**2 + x2**2 - 225.0


def _g_srn_2(x):
    x1, x2 = _srn_xy(x)
    return x1 - 3 * x2 + 10.0


_REGISTRY = {
    "multi_obj_1D": MOProblem("multi_obj_1D", 1, (-1.0, -1.0, 1.0, 3.0),
                              0.47941844, _f_1d),
    "multi_obj_1D_2": MOProblem("multi_obj_1D_2", 1, (-1.0, -4.0, 1.0, 1.0),
                                0.47941844, _f_1d_2),
    "multi_obj_1D_3": MOProblem("multi_obj_1D_3", 1, (-16.0, -11.0, 6.0, 3.0),
                                0.47941844, _f_1d_3),
    "multi_obj_1D_4": MOProblem("multi_obj_1D_4", 1, (-16.0, -11.0, 6.0, 3.0),
                                0.47941844, _f_1d_4),
    "kursawe": MOProblem("kursawe", 3, (-22.0, -14.0, 50.0, 50.0),
                         0.47941844, _f_kursawe),
    "kursawe_10d": MOProblem("kursawe_10d", 10, (-95.0, -45.0, -60.0, 10.0),
                             0.47941844, _f_kursawe),
    "deb6": MOProblem("deb6", 10, (0.0, 0.0, 1.0, 1.0), 0.32164096, _f_deb6),
    "dtlz1a": MOProblem("dtlz1a", 6, (-550.0, -550.0, 0.0, 0.0),
                        0.41692852, _f_dtlz1a),
    # hv_max is unused/unreliable across the registry (the reference
    # repeats one constant); 0.0 marks "not set"
    "bnh": MOProblem("bnh", 2, (0.0, 4.0, 140.0, 50.0), 0.0, _f_bnh,
                     cons=(_g_bnh_1, _g_bnh_2)),
    "srn": MOProblem("srn", 2, (0.0, -300.0, 300.0, 100.0), 0.0, _f_srn,
                     cons=(_g_srn_1, _g_srn_2)),
}


def get(name: str) -> MOProblem:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown problem {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def names():
    return sorted(_REGISTRY)


# reference-parity constructors: multi_obj_1D_4() etc.
def _make_ctor(name):
    def ctor():
        return get(name)

    ctor.__name__ = name
    return ctor


for _name in list(_REGISTRY):
    globals()[_name] = _make_ctor(_name)
