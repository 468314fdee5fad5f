"""Each plain reference against the port, at a tiny size on the CPU: the
port passes, the control (the reference in the precision below the
configuration's) fails, and so does the port with each fault of
``perfbench/faults.py`` planted.

The cells' own limits hold at their own sizes on the card; at these tiny
widths an int8 crossing rounds a larger share of each row differently, so
the tests hold the same numbers to limits of their own
(``limits/<cell>.tiny.json``), set from CPU readings of the port (largest
over 8 seeds) and of the control and the faults (smallest over 2-3
seeds) at the sizes of the ``tiny`` blocks of the cell's files.  A cell
with no tiny limits file is not run here."""
import pytest

from perfbench import common, faults
from perfbench.calibrate import control_records
from perfbench.conftest import tiny_cells

CELLS = tiny_cells()


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_limits_name_the_cells_numbers(cell, small_cell):
    assert set(small_cell(cell)["limits"]) == set(
        common.resolve_cell(cell)["limits"])


def _readings(spec, seed, lowp=False):
    if lowp:
        return common.readings(*control_records(spec, seed, "cpu"))
    drv = common.driver(spec["config"]["driver"])
    sess = drv.Session(spec, seed, "cpu")
    sess.release()
    return common.readings(sess.record, sess.reference_record())


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference(cell, small_cell):
    spec = small_cell(cell)
    ok, checks = common.judge(_readings(spec, 2**31 + 5), spec["limits"])
    assert ok, checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, small_cell):
    spec = small_cell(cell)
    ok, checks = common.judge(_readings(spec, 2**31 + 6, lowp=True),
                              spec["limits"])
    assert not ok, checks


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_fails(cell, fault, small_cell):
    spec = small_cell(cell)
    undo = faults.install(spec["config"]["driver"], fault)
    try:
        values = _readings(spec, 2**31 + 7)
    finally:
        undo()
    ok, checks = common.judge(values, spec["limits"])
    assert not ok, checks
