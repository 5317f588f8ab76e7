"""The benchmark's own tests: ``python -m pytest hsbench/tests -q`` from
the checkout's root. Tests marked ``card`` run only where a CUDA device
is; each decides that inside the test and skips elsewhere."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")
