"""A train step's memory composed by `roofline.composed_cost` against the
full-depth trace, as `test_torch_roofline_compose_train.py` holds it, for
a dense model and for MLA with MoE layers after dense ones, activations
recomputed in backward."""
import pytest

from test_torch_roofline_compose import trace_pairs
from test_torch_roofline_compose_train import check_train

# (arch, shape kind, layers, leading dense layers, attention period,
#  activations recomputed in backward, sequence length)
CASES = [("qwen3-1.7b", "train", 6, None, None, True, 64),
         ("deepseek-v3-671b", "train", 7, 3, None, True, 64)]


@pytest.fixture(scope="module")
def pairs():
    return dict(enumerate(trace_pairs(CASES)))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["-".join(map(str, c[:3])) for c in CASES])
def test_composed_train_memory_holds_the_full_depth_trace(pairs, case):
    check_train(*pairs[case], CASES[case][2])
