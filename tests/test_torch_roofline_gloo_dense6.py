"""The fake group's dry run against an 8-rank gloo train step on real DTensors
(`test_torch_roofline.gloo_equals_fake`), for the dense family with 6 heads
over 4 model ranks (the head merge made whole and split again)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_roofline import gloo_equals_fake  # noqa: E402


@pytest.mark.parametrize("case", ['dense-6-heads'])
def test_fake_group_counts_equal_an_8_rank_gloo_run(case, tmp_path):
    gloo_equals_fake(case, tmp_path)
