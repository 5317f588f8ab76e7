"""Cost-based optimizer: table statistics, cardinality estimates and join
reordering (counterpart of ``hyperspace_tpu/optimizer/``)."""
