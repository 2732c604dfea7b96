"""A train step's memory composed by `roofline.composed_cost` against the
full-depth trace, with activations recomputed in backward as the
production configs run them, at smoke width on the (2 data x 4 model)
fake mesh, sequence 64: each phase's peak of live bytes (forward,
backward, gradients, update) composed exactly but where an op that grows
faster a layer takes a phase's peak over at full depth, the step's peak
within 1% of the full trace's and no more than it, and the full trace's
under the composed bound. The hybrid case has a tail of two mixers after
its groups of three (the production zamba2-7b: groups of six, a tail of
three), whose mixers are not recomputed: composed from a one-mixer tail
its peak reads well under the full trace's. In the vlm case the backward's
peak moves from its first layers to its last between the variants' depths
and the full one. The dense and MLA cases are in
`test_torch_roofline_compose_train_dense_mla.py`."""
import pytest

from repro_torch.launch import dryrun, roofline

from test_torch_roofline_compose import trace_pairs

# (arch, shape kind, layers, leading dense layers, attention period,
#  activations recomputed in backward, sequence length)
CASES = [("zamba2-7b", "train", 17, None, 3, True, 64),
         ("pixtral-12b", "train", 6, None, None, True, 64)]


@pytest.fixture(scope="module")
def pairs():
    return dict(enumerate(trace_pairs(CASES)))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["-".join(map(str, c[:3])) for c in CASES])
def test_composed_train_memory_holds_the_full_depth_trace(pairs, case):
    check_train(*pairs[case], CASES[case][2])


def check_train(full, comp, n_layers):
    """The assertions of one case."""
    assert full["status"] == comp["status"] == "ok"
    check = roofline.composition_check(comp, full)
    assert check["counts_equal"] and check["collectives_equal"], check
    assert comp["memory"]["argument_bytes"] == full["memory"][
        "argument_bytes"]
    assert check["memory_rel"] <= 0.01 and check["memory_bounded"], check
    phases = comp["memory"]["temp_by_phase"]
    assert set(phases) == set(dryrun.PHASES)
    for ph in dryrun.PHASES:
        assert phases[ph] <= full["memory"]["temp_by_phase"][ph], ph
    assert full["memory"]["temp_bytes"] == max(
        full["memory"]["temp_by_phase"].values())
    assert comp["fits"] is True
    assert max(v[0] for v in comp["detail"]["variants"]) < n_layers
