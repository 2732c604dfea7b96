"""starcoder2-3b and pixtral-12b train_4k on 16x16 at 2 layers: the port's
dry-run collectives against GSPMD's compiled program
(`tests/_dryrun_gspmd.py`). starcoder2's 24 query heads do not divide the
16 model ranks, nor do its 2 KV heads or pixtral's 8: each rank receives
its heads' columns and the KV heads its query heads read, through
all-to-alls of only those, and no head is gathered whole."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _dryrun_gspmd import check  # noqa: E402


@pytest.mark.parametrize("cell", ["starcoder2_train", "pixtral_train"])
def test_gqa_train_collectives_within_gspmd(cell):
    check(cell)
