"""zamba2-7b prefill_32k on 16x16 at 6 layers: the port's dry-run
collectives against GSPMD's compiled program (`tests/_dryrun_gspmd.py`),
the Mamba2 input projection taken apart without gathering it."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _dryrun_gspmd import check  # noqa: E402


def test_zamba2_prefill_collectives_within_gspmd():
    check("zamba2_prefill")
