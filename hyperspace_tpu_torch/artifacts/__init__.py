"""Persistent artifact store for the port's compiled kernel libraries
(counterpart of ``hyperspace_tpu/artifacts/``).

The JAX package persists serialized XLA executables on the lake beside the
indexes they serve. The port's compiled programs are its CUDA kernel
libraries (``ops/cuda_kernels.py``, built by ``nvcc`` at first use): with
``hyperspace.tpu.artifacts.enabled`` a library built by one process is
published to the lake (kind ``"kernel"``), and a fresh host or container
fetches it from there instead of running ``nvcc``. See store.py for the
blob protocol and manager.py for the seam.

Import-light: config.py reads the constants.
"""

from .constants import ArtifactConstants  # noqa: F401
