"""Single-objective Bayesian optimization on the port (counterpart of
``dgp_tpu/bo``; the multi-objective and multi-fidelity drivers are not
ported yet)."""

from . import acquisition, de, doe, so_bo
from .acquisition import EI, EV, WB2, WB2S, EV_one_constraint, PoF
from .doe import doe as DoE, lhs
from .so_bo import SO_BO, denormalize, denormalize_var, normalize, normalize_C, normalize_X
