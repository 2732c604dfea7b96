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
    """deepseek-v3 train_4k on 16x16: the norm whose input's two
    gradients came back in layouts DTensor cannot add (MLA's query latent
    under FSDP, split by its columns over `model`) pins its variance's
    gradient, and the latent's gradient keeps its split on any torch: the
    variance's gradient is summed, one float32 (batch / data, seq, 1)
    all-reduce over `model` a norm (and one where the recompute sums the
    variance again), so that no float32 gradient of the latent (batch /
    data, seq, q_lora_rank) is moved or summed. Torch 2.13 moved it
    between its columns' split and its batch's (an all-to-all each way),
    where 2.11 reduce-scattered it."""
    cell = ("deepseek-v3-671b", "train_4k", False)
    rows = [r for r in records[cell]["collectives"]["by_shape"]
            if r["phase"] == "backward" and r["dtype"] == "float32"]
    assert not [r for r in rows if r["shape"][-1] in (1536, 1536 // 16)], \
        rows[:8]
    # a dense and an MoE layer: two latent norms, each summed twice
    assert [r["count"] for r in rows if r["kind"] == "all-reduce"
            and r["axis"] == "model"
            and r["shape"] == [256 // 16, 256, 1]] == [4], rows[:8]


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
