"""The dry run of deepseek-v3-671b's train cells (MLA, leading dense and
MoE layers, MTP, FSDP) on the 16x16 and 2x16x16 meshes, cut for a quick
check and traced on the CPU (`tests/_dryrun_cells.py` says what each case
asserts)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _dryrun_cells as dc  # noqa: E402

CELLS = [c for c in dc.cells(("deepseek-v3-671b",)) if c[1] == "train_4k"]


@pytest.fixture(scope="module")
def records():
    return dc.trace(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids=[dc.cell_id(c) for c in CELLS])
def test_cell_traces_with_the_rules_local_shards(records, cell):
    dc.check(records, cell)


def test_mla_query_latent_pin_stays(records):
    """deepseek-v3 train_4k on 16x16: the one norm whose input's two
    gradients come back in layouts DTensor cannot add (MLA's query latent
    under FSDP) is still pinned: its float32 (batch / data, seq,
    q_lora_rank) gradient is laid out in backward: it moves between its
    columns' split over `model` and its batch's, each move one all-to-all
    of the shard it leaves (a cpu mesh's all-gather and chunk count as the
    card's all-to-all)."""
    cell = ("deepseek-v3-671b", "train_4k", False)
    rows = records[cell]["collectives"]["by_shape"]
    shards = ([256 // 16 // 16, 256, 1536], [256 // 16, 256, 1536 // 16])
    assert [r for r in rows if r["phase"] == "backward"
            and r["dtype"] == "float32" and r["kind"] == "all-to-all"
            and r["shape"] in shards], rows[:8]


@pytest.mark.parametrize("multi", [False, True])
def test_fsdp_gathers_weights_not_activations(records, multi):
    """deepseek-v3 train_4k (FSDP): a block's weights are gathered over the
    data axes before it runs (`common.gather_fsdp`), as GSPMD gathers them;
    no all-reduce over the data axes sums an activation of the whole batch
    (DTensor's own products moved the batch to the weights' split, each
    product a partial sum over the data ranks: the whole batch's logits
    and queries on every device)."""
    cell = ("deepseek-v3-671b", "train_4k", multi)
    rows = records[cell]["collectives"]["by_shape"]
    assert not [r for r in rows if r["axis"] == "data"
                and r["kind"] == "all-reduce" and len(r["shape"]) >= 3
                and r["shape"][0] == 256], rows[:8]



@pytest.mark.parametrize("cell", CELLS, ids=[dc.cell_id(c) for c in CELLS])
def test_cell_gathers_no_heads(records, cell):
    """Attention heads stay split where the rules split them
    (`models.common.split_heads`, `_attention_by_shard`, `merge_dims`,
    `write_rows`): no all-gather over `model` carries whole or padded
    heads, repeated KV heads or a q / k / v projection's columns."""
    assert records[cell]["status"] == "ok"
    assert dc.head_gathers(records[cell]) == []
