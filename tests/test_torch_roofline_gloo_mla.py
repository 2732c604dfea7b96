"""The fake group's dry run against an 8-rank gloo train step on real DTensors
(`test_torch_roofline.gloo_equals_fake`), for MLA with dense and MoE layers
under FSDP (deepseek-v3)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_roofline import gloo_equals_fake  # noqa: E402


@pytest.mark.parametrize("case", ['mla-moe-fsdp'])
def test_fake_group_counts_equal_an_8_rank_gloo_run(case, tmp_path):
    gloo_equals_fake(case, tmp_path)
