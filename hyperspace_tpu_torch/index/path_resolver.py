"""Resolves index names to paths under the system path (counterpart of
``hyperspace_tpu/index/path_resolver.py``)."""

from __future__ import annotations

import os

from ..config import HyperspaceConf


class PathResolver:
    def __init__(self, conf: HyperspaceConf):
        self._conf = conf

    @property
    def system_path(self) -> str:
        return self._conf.system_path()

    def get_index_path(self, name: str) -> str:
        return os.path.join(self.system_path, name)
