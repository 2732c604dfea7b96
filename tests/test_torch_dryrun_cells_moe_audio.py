"""The dry run of the MoE olmoe-1b-7b and the audio whisper-large-v3 (20 heads
over 16 ranks): every applicable cell on the 16x16 and 2x16x16 meshes, cut
for a quick check and traced on the CPU (`tests/_dryrun_cells.py` says what
each case asserts)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _dryrun_cells as dc  # noqa: E402

CELLS = dc.cells(('olmoe-1b-7b', 'whisper-large-v3'))
VARIANTS = dc.variants(('olmoe-1b-7b', 'whisper-large-v3'))


@pytest.fixture(scope="module")
def records():
    return dc.trace(CELLS + VARIANTS)


@pytest.mark.parametrize("cell", CELLS, ids=[dc.cell_id(c) for c in CELLS])
def test_cell_traces_with_the_rules_local_shards(records, cell):
    dc.check(records, cell)


@pytest.mark.parametrize("cell", VARIANTS,
                         ids=[dc.cell_id(c) for c in VARIANTS])
def test_variant_counts_the_card_collectives(records, cell):
    """The cell two layers deep counts what the card's torch counts on a
    cuda mesh (`_dryrun_cells.CARD_RECORDS`)."""
    dc.check_variant(records, cell)


@pytest.mark.parametrize("cell", CELLS, ids=[dc.cell_id(c) for c in CELLS])
def test_cell_gathers_no_heads(records, cell):
    """Attention heads stay split where the rules split them
    (`models.common.split_heads`, `_attention_by_shard`, `merge_dims`,
    `write_rows`): no all-gather over `model` carries whole or padded
    heads, repeated KV heads or a q / k / v projection's columns."""
    assert records[cell]["status"] == "ok"
    assert dc.head_gathers(records[cell]) == []
