"""Plan analysis: explain and its display modes."""
