"""The dry run of rwkv6-1.6b (the WKV scan; long_500k's decode at batch 1):
every applicable cell on the 16x16 and 2x16x16 meshes, cut for a quick check
and traced on the CPU (`tests/_dryrun_cells.py` says what each case
asserts); and train_4k on 16x16 at 2 layers against GSPMD's compiled
program (`tests/_dryrun_gspmd.py`). That case traces the WKV loop token by
token, about two minutes on a CPU; it sits in this file, whose many cases
pytest-xdist's `--dist loadfile` starts early, rather than in a file of
its own, which it would start last."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _dryrun_cells as dc  # noqa: E402
from _dryrun_gspmd import check  # noqa: E402

CELLS = dc.cells(('rwkv6-1.6b',))


@pytest.fixture(scope="module")
def records():
    return dc.trace(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids=[dc.cell_id(c) for c in CELLS])
def test_cell_traces_with_the_rules_local_shards(records, cell):
    dc.check(records, cell)


@pytest.mark.parametrize("cell", CELLS, ids=[dc.cell_id(c) for c in CELLS])
def test_cell_gathers_no_heads(records, cell):
    """Attention heads stay split where the rules split them
    (`models.common.split_heads`, `_attention_by_shard`, `merge_dims`,
    `write_rows`): no all-gather over `model` carries whole or padded
    heads, repeated KV heads or a q / k / v projection's columns."""
    assert records[cell]["status"] == "ok"
    assert dc.head_gathers(records[cell]) == []


def test_rwkv6_train_collectives_within_gspmd():
    """The decay comes out split by heads as r, k and v do (its LoRA rank
    made whole before `decay_B`), and the WKV output's layer norm sums its
    mean and variance over the heads' split: the port's all-gathers over
    `model` are within `GATHER_RATIO` of GSPMD's gathers and permutes, its
    total within `TOTAL_RATIO`."""
    check("rwkv6_train")
