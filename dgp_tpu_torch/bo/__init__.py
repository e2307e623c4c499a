"""Bayesian optimization on the port (counterpart of ``dgp_tpu/bo``): the
single-objective driver ``SO_BO`` and the multi-fidelity driver ``MF_BO``
and the multi-objective test problems (the multi-objective driver and
EHVI are not ported yet)."""

from . import acquisition, de, doe, mf_bo, problems, so_bo
from .acquisition import EI, EV, WB2, WB2S, EV_one_constraint, PoF
from .doe import doe as DoE, lhs
from .mf_bo import MF_BO
from .so_bo import SO_BO, denormalize, denormalize_var, normalize, normalize_C, normalize_X
