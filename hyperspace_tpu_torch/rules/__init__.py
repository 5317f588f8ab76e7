"""The hyperspace rewrite rules and plan normalization."""
