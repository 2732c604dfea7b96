"""zamba2-7b train_4k on 16x16 at 6 layers (one group of five Mamba2
mixers and the shared attention block): the port's dry-run collectives
against GSPMD's compiled program (`tests/_dryrun_gspmd.py`). The Mamba2
input projection, split over `model` in columns that fall across its
z / x / B / C / dt boundaries, is taken apart moving only those columns,
as GSPMD's collective-permutes move them: no all-gather of the projection
or of the scan's heads."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _dryrun_gspmd import check  # noqa: E402


def test_zamba2_train_collectives_within_gspmd():
    check("zamba2_train")
