"""Build a port ``Table`` from plain numpy columns.

A JAX-package ``Table``'s columns, fetched to numpy by the caller
(``np.asarray`` on data and validity, plus the host dictionary of string
columns), become a device ``Table`` here, so both packages can be fed the
same device inputs. Nothing here imports the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..execution.columnar import DEVICE_DTYPE, Column, Table

# name -> (logical dtype, data, validity or None, dictionary or None)
NumpyColumns = Dict[str, Tuple[str, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]]


def table_from_numpy(columns: NumpyColumns, device="cuda") -> Table:
    """The columns as a ``Table`` on ``device`` (the card by default, as
    ``Session``; tests on the CPU pass ``device="cpu"``)."""
    out = {}
    for name, (dtype, data, validity, dictionary) in columns.items():
        tensor = torch.from_numpy(np.array(data, copy=True)).to(device)
        if tensor.dtype != DEVICE_DTYPE[dtype]:
            tensor = tensor.to(DEVICE_DTYPE[dtype])
        valid = None if validity is None else \
            torch.from_numpy(np.array(validity, dtype=np.bool_, copy=True)).to(device)
        out[name] = Column(dtype, tensor, valid, dictionary)
    return Table(out)
