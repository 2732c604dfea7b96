"""The dry run of the dense family: qwen3-1.7b, qwen1.5-4b (20 heads over 16
ranks) and deepseek-7b: every applicable cell on the 16x16 and 2x16x16
meshes, cut for a quick check and traced on the CPU
(`tests/_dryrun_cells.py` says what each case asserts)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _dryrun_cells as dc  # noqa: E402

CELLS = dc.cells(('qwen3-1.7b', 'qwen1.5-4b', 'deepseek-7b'))
VARIANTS = dc.variants(('qwen3-1.7b', 'qwen1.5-4b', 'deepseek-7b'))


@pytest.fixture(scope="module")
def records():
    return dc.trace(CELLS + VARIANTS)


@pytest.mark.parametrize("cell", CELLS, ids=[dc.cell_id(c) for c in CELLS])
def test_cell_traces_with_the_rules_local_shards(records, cell):
    dc.check(records, cell)


def test_no_norm_all_reduces_a_float32_residual_gradient(records):
    """deepseek-7b train_4k on 16x16 (one layer, three RMS norms): the
    residual stream's partial sums, and its gradient's, are summed in the
    compute dtype (one all-reduce of the (batch, seq, d) bfloat16 tensor
    a norm each way); the norms no longer all-reduce its float32 form (20
    such collectives before, 6 of them the two gradient pins of each
    norm)."""
    cell = ("deepseek-7b", "train_4k", False)
    rows = records[cell]["collectives"]["by_shape"]
    residual = [256 // 16, 256, 4096]           # (batch / data, seq, d)
    assert not [r for r in rows if r["shape"] == residual
                and r["dtype"] == "float32"], rows[:8]
    summed = [r for r in rows if r["shape"] == residual
              and r["kind"] == "all-reduce" and r["dtype"] == "bfloat16"]
    assert {r["phase"] for r in summed} == {"forward", "backward"}


@pytest.mark.parametrize("cell", VARIANTS,
                         ids=[dc.cell_id(c) for c in VARIANTS])
def test_variant_counts_the_card_collectives(records, cell):
    """The cell two layers deep counts what the card's torch counts on a
    cuda mesh (`_dryrun_cells.CARD_RECORDS`)."""
    dc.check_variant(records, cell)


def test_residual_is_summed_once_a_norm_each_way(records):
    """qwen1.5-4b train_4k on 16x16, two layers deep: the residual stream
    (batch / data, seq, d) is summed in bfloat16 over `model` as often as
    GSPMD sums it, on any torch. Forward: once where the embedding's rows
    meet and once a sublayer's output (5; `common.residual`). Backward:
    once a norm, its output's gradient before its float32 backward (5:
    four block norms and the final one; GSPMD sums a block norm's input
    gradients in one combined all-reduce, and the final norm's chunk by
    chunk in the loss), and once a layer where the recompute meets the
    attention's output again (2; GSPMD's `rematted_computation` sum;
    `python tests/_dryrun_gspmd.py ops qwen15_train` lists them). Torch 2.13's DTensor left each add's sum pending, so that each
    layer's recompute summed its input again (8 backward), where 2.11
    summed it at the add (7)."""
    cell = ("qwen1.5-4b", "train_4k", False, 2)
    rows = records[cell]["collectives"]["by_shape"]
    residual = [256 // 16, 256, 2560]
    summed = {r["phase"]: r["count"] for r in rows
              if r["shape"] == residual and r["kind"] == "all-reduce"
              and r["axis"] == "model" and r["dtype"] == "bfloat16"}
    assert summed == {"forward": 5, "backward": 7}, summed
    assert not [r for r in rows if r["shape"] == residual
                and r["dtype"] == "float32"], rows[:8]



@pytest.mark.parametrize("cell", CELLS, ids=[dc.cell_id(c) for c in CELLS])
def test_cell_gathers_no_heads(records, cell):
    """Attention heads stay split where the rules split them
    (`models.common.split_heads`, `_attention_by_shard`, `merge_dims`,
    `write_rows`): no all-gather over `model` carries whole or padded
    heads, repeated KV heads or a q / k / v projection's columns."""
    assert records[cell]["status"] == "ok"
    assert dc.head_gathers(records[cell]) == []
