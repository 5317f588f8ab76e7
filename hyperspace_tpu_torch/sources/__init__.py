"""File-based source relations."""
