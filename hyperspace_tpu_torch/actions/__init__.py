"""Index actions run under the op-log protocol (create, delete, vacuum)."""
