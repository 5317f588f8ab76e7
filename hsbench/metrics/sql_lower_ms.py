"""SQL front end: the mean host milliseconds of ``session.sql(text)`` per
query answered in the window (the benchmark's clock around the call)."""


def read(r):
    lows = [q.lower_s for q in r.queries if q.lower_s > 0]
    return 1000.0 * sum(lows) / len(lows) if lows else None
