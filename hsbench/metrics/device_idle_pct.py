"""device: the share of the profiled slice in which no operation ran on
the card: 100 x (1 - the union of the device records' intervals over the
slice's length)."""

from hsbench import reduce as red


def read(r):
    if r.slice is None:
        return None
    lo, hi = r.slice
    busy = red.covered([(s, e) for _, s, e in r.device_events], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo)) if hi > lo else None
