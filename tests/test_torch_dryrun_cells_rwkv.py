"""The dry run of rwkv6-1.6b (the WKV scan; long_500k's decode at batch 1):
every applicable cell on the 16x16 and 2x16x16 meshes, cut for a quick check
and traced on the CPU (`tests/_dryrun_cells.py` says what each case
asserts)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _dryrun_cells as dc  # noqa: E402

CELLS = dc.cells(('rwkv6-1.6b',))


@pytest.fixture(scope="module")
def records():
    return dc.trace(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids=[dc.cell_id(c) for c in CELLS])
def test_cell_traces_with_the_rules_local_shards(records, cell):
    dc.check(records, cell)
