"""Collection of ``tests/test_portbench_faults.py``.

That file keeps each cell's small sizes and planted faults in its own
tables, ``SMALL`` and ``FAULTS``, and parametrises its whole runs over
every cell of ``BENCHMARK.json``, indexing those tables by each while it
is collected.  A cell whose whole runs and faults live in a test file of
its own (config 4's, in ``test_portbench_online.py``) is not in the tables
and would stop that file at collection, and with it the runs of the cells
it does name.  So while it is collected, ``spec.benchmark()`` lists the
cells its ``SMALL`` names, and no others; every other file, and every run,
sees the whole benchmark."""

import ast

import pytest

FAULTS_FILE = "test_portbench_faults.py"


def tabled_cells(path):
    """The keys of the literal dict ``SMALL`` in the Python file at
    ``path``, or None where it has none."""
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign)
                and [getattr(t, "id", None) for t in node.targets]
                == ["SMALL"]):
            return set(ast.literal_eval(node.value))
    return None


@pytest.hookimpl(hookwrapper=True)
def pytest_make_collect_report(collector):
    cells = None
    if (isinstance(collector, pytest.Module)
            and collector.path.name == FAULTS_FILE):
        cells = tabled_cells(collector.path)
    if cells is None:
        yield
        return
    from portbench.core import spec

    whole = spec.benchmark

    def tabled(*args, **kwargs):
        b = whole(*args, **kwargs)
        return b | {"workloads": [w for w in b["workloads"]
                                  if w["name"] in cells]}

    spec.benchmark = tabled
    try:
        yield
    finally:
        spec.benchmark = whole
