"""The check that decides ``correct``, shown to fail.

Each cell runs the whole harness in the CPU rehearsal (the look for a card
skipped, a tiny size) three ways: as it is (``correct``), with the
reference in TF32 put in the program's place (the control), and with each
fault of ``faults.py`` that the cell can have planted in the timed path.
Only the first may come out correct.
"""

import pytest

from benchmark import catalog, faults, harness

SERVING = ["m5-highsr.songs", "m6-multi.songs44k", "m5-highsr.clips"]
TRAINING = ["m5-highsr.train-b16"]


def run(cell, seed=21, **kw):
    out, readings = harness.run(cell, seed, 0.2, rehearsal=True, **kw)
    return out, readings


@pytest.mark.parametrize("cell", catalog.cells())
def test_a_sound_run_is_correct(cell):
    out, readings = run(cell)
    assert out["correct"], readings
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(catalog.cell(cell)["limits"])


@pytest.mark.parametrize("cell", catalog.cells())
def test_the_tf32_control_is_not_correct(cell):
    out, readings = run(cell, control="tf32")
    assert not out["correct"], readings


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in SERVING for f in faults.SERVING] + [
    (c, f) for c in TRAINING for f in faults.TRAINING])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    with faults.ALL[fault]():
        out, readings = run(cell)
    assert not out["correct"], (fault, readings)


def test_the_cells_are_covered():
    assert sorted(SERVING + TRAINING) == catalog.cells()
