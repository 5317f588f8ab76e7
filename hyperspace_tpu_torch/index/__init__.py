"""Index metadata: the op log, data layout, signatures and the index manager."""
