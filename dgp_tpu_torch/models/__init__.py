"""Deep GP models. The parameters live in ``nn.Module``s (``DGPParams``
and its kin); the JAX package's pytree structs of the same names have no
counterpart here (``convert.py`` maps one to the other)."""

from . import dgp, gpr, mf_dgp, mf_dgp_em, mo_dgp, training  # noqa: F401
from .dgp import DGP  # noqa: F401
from .gpr import GPR  # noqa: F401
from .mf_dgp import MultiFidelityDeepGP  # noqa: F401
from .mf_dgp_em import MultiFidelityDeepGP_EM  # noqa: F401
from .mo_dgp import MultiObjDeepGP  # noqa: F401
