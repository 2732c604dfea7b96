"""`roofline.composed_cost` against the full-depth trace, on the CPU at smoke
width on the (2 data x 4 model) fake mesh: the full depth's FLOPs (by
class and of the products), collective counts and bytes by kind and axis
and argument bytes composed exactly from the small-depth variants, its
bytes within 1e-6 (`roofline.composition_check`, which every cell of
`launch.roofline_all` records at production size), and a device's memory
composed phase by phase within 1% of the full-depth trace's and no more
than it, with the full trace's under the composed bound. The smoke depths
are deeper than every variant, so each composition extrapolates. The
train cases with activations recomputed in backward, as the production
configs run them, are in `test_torch_roofline_compose_train.py`."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (arch, shape kind, layers, leading dense layers, attention period,
#  activations recomputed in backward, sequence length)
CASES = [("deepseek-7b", "train", 5, None, None, False, 32),
         ("olmoe-1b-7b", "train", 4, None, None, False, 32),
         ("deepseek-7b", "prefill", 5, None, None, False, 32),
         ("deepseek-v3-671b", "prefill", 7, 3, None, False, 32),
         ("zamba2-7b", "prefill", 9, None, None, False, 32),
         ("zamba2-7b", "decode", 9, None, None, False, 32),
         ("rwkv6-1.6b", "decode", 4, None, None, False, 32),
         ("whisper-large-v3", "decode", 4, None, None, False, 32)]

_SCRIPT = r"""
import dataclasses, json, sys
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, roofline
out = []
for arch, kind, n, nd, period, remat, seq in json.loads(sys.argv[1]):
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=n,
                              remat=remat)
    if nd is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_dense_layers=nd))
    if period is not None:
        cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
            cfg.hybrid, attn_period=period))
    shape = ShapeConfig("small", seq, 4 if seq == 32 else 8, kind)
    kw = dict(shape=shape, mesh_shape={"data": 2, "model": 4},
              device="cpu")
    full = dryrun.lower_cell(arch, "small", False, cfg, **kw)
    comp = roofline.composed_cost(arch, "small", cfg, **kw)
    out.append([full, comp])
print("RESULT " + json.dumps(out))
"""


def trace_pairs(cases):
    """[(full-depth record, composed record)] of `cases`, traced in one
    subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _SCRIPT, json.dumps(cases)],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def pairs():
    return dict(enumerate(trace_pairs(CASES)))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["-".join(map(str, c[:3])) for c in CASES])
def test_composed_cost_equals_the_full_depth_trace(pairs, case):
    full, comp = pairs[case]
    assert full["status"] == comp["status"] == "ok"
    check = roofline.composition_check(comp, full)
    assert check["counts_equal"] and check["collectives_equal"], check
    assert comp["memory"]["argument_bytes"] == full["memory"][
        "argument_bytes"]
    assert check["bytes_rel"] <= 1e-6, check
    assert check["memory_rel"] <= 0.01 and check["memory_bounded"], check
    assert comp["params"] == full["params"]
    assert max(v[0] for v in comp["detail"]["variants"]) < CASES[case][2]
