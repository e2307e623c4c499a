"""Bayesian optimization on the port (counterpart of ``dgp_tpu/bo``): the
single-objective driver ``SO_BO``, the multi-fidelity driver ``MF_BO``, the
multi-objective driver ``MO_BO`` with EHVI and the Pareto utilities, and
the multi-objective test problems."""

from . import acquisition, de, doe, ehvi, mf_bo, mo_bo, problems, so_bo
from .acquisition import EI, EV, WB2, WB2S, EV_one_constraint, PoF
from .doe import doe as DoE, lhs
from .ehvi import (EHVI, HV_calcul, NDC, Y_ND, ehvi_mc, hypervolume,
                   optimize_EHVI, pareto_mask, psi)
from .mf_bo import MF_BO
from .mo_bo import MO_BO
from .so_bo import SO_BO, denormalize, denormalize_var, normalize, normalize_C, normalize_X
