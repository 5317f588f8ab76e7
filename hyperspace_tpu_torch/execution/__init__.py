"""Columnar tables on the device, predicate evaluation and the plan executor."""
