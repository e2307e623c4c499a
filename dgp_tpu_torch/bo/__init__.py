"""Bayesian optimization on the port (counterpart of ``dgp_tpu/bo``): the
single-objective driver ``SO_BO`` and the multi-fidelity driver ``MF_BO``
(the multi-objective driver is not ported yet)."""

from . import acquisition, de, doe, mf_bo, so_bo
from .acquisition import EI, EV, WB2, WB2S, EV_one_constraint, PoF
from .doe import doe as DoE, lhs
from .mf_bo import MF_BO
from .so_bo import SO_BO, denormalize, denormalize_var, normalize, normalize_C, normalize_X
