"""Variational distributions."""

from .gaussian import gauss_kl  # noqa: F401
from .natgrad import natgrad_step, natgrad_step_multi  # noqa: F401
