"""Re-export shim: the port's observability names where the JAX package
keeps its ``dask_ml_tpu/utils/observability.py``."""

from ..observability import *  # noqa: F401,F403
from ..observability import __all__  # noqa: F401
