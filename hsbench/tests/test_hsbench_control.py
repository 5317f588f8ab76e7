"""The comparison that decides ``correct`` fails what it must: its
control (the reference worked out in float32 in the program's place), and
runs with the timed path broken underneath (an answer altered where it is
produced; half of each answer's rows left out; a query refused by the
frontend). Sound runs pass. Tiny
scale, on the CPU: the harness's look for a card is skipped, the rest of
a run is driven as on the card."""

import pytest

from hsbench.tests import _cpu

# Every workload file, so that a cell added as a file is held to the same.
CELLS = _cpu.workload_names()


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _cpu.run(cell, seed=2 ** 32 + 17)
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_is_not_correct(cell):
    r = _cpu.run(cell, seed=2 ** 32 + 18, control="float32")
    assert r["correct"] is False, r["checks"]


def _altered(table):
    """The first float64 column times (1 + 1e-6), or the first integer
    column plus one: one answer altered where it is produced."""
    import pyarrow as pa
    import pyarrow.compute as pc
    for i, f in enumerate(table.schema):
        if pa.types.is_float64(f.type):
            return table.set_column(i, f.name, pc.multiply(table.column(i), 1.000001))
    for i, f in enumerate(table.schema):
        if pa.types.is_integer(f.type):
            return table.set_column(i, f.name, pc.add(table.column(i), 1).cast(f.type))
    return table


def _halved(table):
    return table.slice(0, table.num_rows // 2) if table.num_rows > 1 else table


@pytest.mark.parametrize("fault", [_altered, _halved], ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    from hyperspace_tpu_torch.execution import columnar
    to_arrow = columnar.Table.to_arrow
    monkeypatch.setattr(columnar.Table, "to_arrow", lambda self: fault(to_arrow(self)))
    r = _cpu.run(cell, seed=2 ** 32 + 19)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_refused_query_is_not_correct(cell, monkeypatch):
    """One query of the window refused where the frontend takes it in: its
    answer is never compared, and the run is not correct all the same."""
    from hsbench import harness
    from hyperspace_tpu_torch.exceptions import ServingRejectedError
    from hyperspace_tpu_torch.serving.frontend import ServingFrontend
    submit = ServingFrontend.submit
    calls = []

    def refuse_third(self, *a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise ServingRejectedError("serving admission rejected query: planted")
        return submit(self, *a, **k)

    warm_up = harness.warm_up

    def warm_up_then_refuse(*a, **k):
        warm_up(*a, **k)
        monkeypatch.setattr(ServingFrontend, "submit", refuse_third)

    monkeypatch.setattr(harness, "warm_up", warm_up_then_refuse)
    r = _cpu.run(cell, seed=2 ** 32 + 20)
    assert r["failed"] == 1
    assert r["checks"]["failed_queries"] == {"value": 1, "limit": 0}
    assert r["correct"] is False, r["checks"]
