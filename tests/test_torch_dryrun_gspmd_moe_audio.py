"""olmoe-1b-7b and whisper-large-v3 train_4k on 16x16 at 2 layers: the
port's dry-run collectives against GSPMD's compiled program
(`tests/_dryrun_gspmd.py`)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _dryrun_gspmd import check  # noqa: E402


@pytest.mark.parametrize("cell", ["olmoe_train", "whisper_train"])
def test_moe_audio_train_collectives_within_gspmd(cell):
    check(cell)
