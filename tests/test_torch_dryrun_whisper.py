"""whisper-large-v3 decode_32k on the 16x16 mesh against JAX's lower_cell
(as `test_torch_roofline.py` holds olmoe-1b-7b's cell): 20 heads over 16
model ranks, so the port's head merge makes the heads whole and splits the
merged dim again. Parameter counts equal; the port's argument bytes are
JAX's but for the 4-byte position scalar JAX's step takes as an array, and
for the encoder's weights, which the decode step never reads and JAX's jit
leaves out of the compiled arguments (`keep_unused=False`) while the
port's step is handed them. The products of one decoder layer plus the
rest fall within 10% of the HLO's dots (XLA counts the layer scan's body
once). The collective bytes fall within `tests/_dryrun_gspmd.py`'s bounds
of GSPMD's, read off the same compiled program."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_roofline import _JAX_CELL, _run  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as specs_mod  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import sharding  # noqa: E402
import _dryrun_cells as dc  # noqa: E402
import _dryrun_gspmd as gspmd  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))

_PORT = r"""
import json
from repro_torch.launch import dryrun
rec = dryrun.lower_cell("whisper-large-v3", "decode_32k", False, device="cpu")
print("RESULT " + json.dumps(rec))
"""


@pytest.fixture(scope="module")
def whisper_cells():
    """(JAX's record, with its compiled program's collectives weighted by
    their loops' trip counts under "weighted"; the port's record)."""
    jax_cell = _JAX_CELL.replace('"olmoe-1b-7b"', '"whisper-large-v3"')
    assert jax_cell != _JAX_CELL
    weigh = (f"import sys\nsys.path.insert(0, {TESTS!r})\n"
             "from _dryrun_gspmd import weighted_collectives\n"
             "rec['weighted'] = weighted_collectives(text)\n")
    jax_cell = jax_cell.replace('print("RESULT "', weigh + 'print("RESULT "')
    return _run(jax_cell), _run(_PORT)


def _encoder_bytes():
    """The bytes one device of the 16x16 mesh holds of the encoder's
    weights, in the serving (compute) dtype."""
    cfg = get_config("whisper-large-v3")
    meta = specs_mod.meta_model(build(cfg, device="cpu"))
    params = adamw.tree_map(lambda t: t.to(meta.cdt), meta.init(
        specs_mod.MetaDraw()))
    mesh = {"data": 16, "model": 16}
    specs = sharding.param_specs(mesh, params)
    return sum(dc._placed_bytes(params[k], specs[k], mesh)
               for k in ("enc_blocks", "enc_norm"))


def test_whisper_decode_cell_counts_and_sizes_as_jax(whisper_cells):
    jax_rec, rec = whisper_cells
    assert rec["status"] == jax_rec["status"] == "ok"
    assert (rec["mesh"], rec["chips"]) == (jax_rec["mesh"], 256)
    assert rec["params"] == jax_rec["params"]
    assert rec["active_params"] == jax_rec["active_params"]
    assert rec["memory"]["argument_bytes"] == \
        jax_rec["memory"]["argument_bytes"] - 4 + _encoder_bytes()
    d = rec["detail"]
    assert d["dec_blocks"]["n_layers"] == 32
    scan_form = d["outside_layers_dot_flops"] + d["dec_blocks"][
        "layer_dot_flops"]
    assert abs(scan_form - jax_rec["hlo_dot_flops"]) <= \
        0.10 * jax_rec["hlo_dot_flops"], (scan_form, jax_rec["hlo_dot_flops"])
    assert rec["fits"]
    assert set(rec["collectives"]["bytes_by_axis"]) <= {"data", "model"}


def test_whisper_decode_collectives_within_gspmd(whisper_cells):
    """The port's collective bytes against the program GSPMD compiles for
    the same cell, each collective in the layer loop's body weighted by its
    trip count, to the bounds of `tests/_dryrun_gspmd.py`. GSPMD gathers
    the encoder memory along d_model once, ahead of the loop, and each
    layer regroups its K / V columns; the port gathers the memory once and
    routes each layer's K / V columns to its heads."""
    jax_rec, rec = whisper_cells
    r = gspmd.readings(jax_rec["weighted"], rec["collectives"])
    assert r["total_ratio"] <= gspmd.TOTAL_RATIO, r
    assert r["gather_ratio"] <= gspmd.GATHER_RATIO, r
