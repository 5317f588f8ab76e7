"""The logical plan IR: expressions and plan nodes."""
