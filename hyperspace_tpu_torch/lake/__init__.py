"""Versioned lake table formats over parquet parts (counterpart of
``hyperspace_tpu/lake/``): ``delta`` (commit-log tables) and ``iceberg``
(snapshot/manifest tables). Query and index integration lives in
``sources/delta.py`` and ``sources/iceberg.py``.
"""

from .delta import DeltaTable  # noqa: F401
from .iceberg import IcebergTable  # noqa: F401
