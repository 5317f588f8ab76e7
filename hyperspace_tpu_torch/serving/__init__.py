"""The serving tier (counterpart of ``hyperspace_tpu/serving/``).

The result cache keyed by plan fingerprint, sources, index log versions
and conf (result_cache.py, fingerprint.py) with the SQL plan memo in
``Session.sql``; explicit per-query contexts (context.py); literal sweeps,
which run queries that differ only in filter literals over one shared scan
(batcher.py); and the multi-session frontend
with admission control (frontend.py); and the process-wide program bank
(program_bank.py), which counts the fused and mesh stages' programs as the
JAX package compiles them. The conf keys are ``serving.result_cache.*``
and ``hyperspace.tpu.serving.*`` (constants.py).
"""

from .constants import ServingConstants  # noqa: F401
from .context import QueryContext  # noqa: F401
from .fingerprint import ResultCacheKey, compute_key  # noqa: F401
from .result_cache import ResultCache, build_result_cache  # noqa: F401
