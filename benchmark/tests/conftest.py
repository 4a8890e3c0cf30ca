"""Registrations for loops added after ``_small.py`` and ``control.py``.

``_small.LOOPS`` holds each loop's tiny CPU sizes by loop name, and
``control.control_readings`` picks a loop's control by name; a later loop
brings its own (``SMALL_CONFIG``, ``SMALL_TRAFFIC``, ``control_readings``)
and is registered here, so that every test parametrised over the cells of
``BENCHMARK.json`` runs it too.
"""

from benchmark import control
from benchmark.loops import extract_i3d
from benchmark.tests import _small

_small.LOOPS.setdefault("extract_i3d", (extract_i3d.SMALL_CONFIG, extract_i3d.SMALL_TRAFFIC))

_control_readings = control.control_readings


def _with_later_loops(loop_name: str, cell, limits: dict) -> dict:
    if loop_name == "extract_i3d":
        return extract_i3d.control_readings(cell)
    return _control_readings(loop_name, cell, limits)


control.control_readings = _with_later_loops
