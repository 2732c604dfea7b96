"""The sanitize module's case list (`repro_torch.kernels.sanitize.CASES`)
against the JAX package, and its checking machinery, on the CPU.

Every case must pass its kernel's launch rule, so that the list cannot rot
while the card is away. At every case the port's plain version (the
wrapper on CPU tensors, as `sanitize.plain` runs it) is held against the
JAX `ref.py` oracle and the Pallas kernel in interpret mode with
`pipeline=False`, lane by lane, on the same seeded numpy inputs, at the JAX
tests' tolerances (TAF / iACT / perforated matmul 1e-3, attention 1e-4 in
float32 and 0.05 in bfloat16). A masked case is held to the structural
oracle at its fraction, which the masked kernels equal
(`tests/test_torch_kernels.py`, `test_torch_perforated_matmul.py`); a GQA
case to the oracle on K and V repeated over each group. The kernels
themselves run these cases on the card: `chip_smoke.py` phase 3b and
`tests/test_torch_cuda.py::TestSanitizeOnCard`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.kernels import ref as jref
from repro.kernels.iact_memo import iact_rowfn as pallas_iact
from repro.kernels.perforated_attention import \
    perforated_attention as pallas_attention
from repro.kernels.perforated_matmul import \
    perforated_matmul as pallas_pmm
from repro.kernels.taf_matmul import taf_matmul as pallas_taf
from repro_torch.kernels import _build, sanitize, taf_matmul

ATOL = {"taf_matmul": 1e-3, "iact_rowfn": 1e-3, "perforated_matmul": 1e-3,
        "float32": 1e-4, "bfloat16": 0.05}
CASES = {c.name: c for c in sanitize.CASES}


def _jperfo(perfo, fraction=None):
    """The JAX package's perforation at a masked case's fraction."""
    if perfo is None:
        return None
    kind = jtypes.PerforationKind(perfo.kind.value)
    if perfo.kind.value in ("small", "large"):
        return jtypes.PerforationParams(kind=kind, skip=perfo.skip)
    return jtypes.PerforationParams(
        kind=kind, fraction=perfo.fraction if fraction is None else fraction)


def _lane(a, i, nd):
    return a[i] if a.ndim == nd + 1 else a


def _knobs(case):
    return case.knob if case.lanes else (case.knob,)


def _port(case):
    """The port's plain outputs, with a lane axis in front."""
    out = [o.float().numpy() if o.dtype != torch.bool else o.numpy()
           for o in sanitize.plain(case)]
    return [o if case.lanes else o[None] for o in out]


def _oracles(case, lane, knob):
    """(JAX ref outputs, Pallas interpret outputs) of one lane."""
    a = sanitize.arrays(case)
    kw = case.kwargs
    if case.kernel == "taf_matmul":
        x, w = _lane(a["x"], lane, 2), _lane(a["w"], lane, 2)
        tk = dict(block_m=kw["block_m"], block_n=kw["block_n"],
                  history_size=kw["history_size"],
                  prediction_size=kw["prediction_size"], rsd_threshold=knob)
        return (jref.taf_matmul_ref(x, w, **tk),
                pallas_taf(jnp.asarray(x), jnp.asarray(w), interpret=True,
                           pipeline=False, **tk))
    if case.kernel == "iact_rowfn":
        ins = [_lane(a[n], lane, 2) for n in ("x", "w1", "w2")]
        ik = dict(block_rows=kw["block_rows"], table_size=kw["table_size"],
                  threshold=knob)
        return (jref.iact_rowfn_ref(*ins, **ik),
                pallas_iact(*map(jnp.asarray, ins), interpret=True, **ik))
    # a fraction of 1 drops every block: the structural oracle has no such
    # perforation, and the masked kernels give 0 (Pallas included)
    every = knob is not None and knob >= 1.0
    if case.kernel == "perforated_matmul":
        x, w = a["x"], a["w"]
        perfo = kw["perfo"]
        ref = np.zeros((x.shape[0], w.shape[1]), np.float32) if every else \
            jref.perforated_matmul_ref(
                x, w, block_k=kw["block_k"], perfo=_jperfo(perfo, knob),
                rescale=kw["rescale"])
        pallas = pallas_pmm(
            jnp.asarray(x), jnp.asarray(w), block_m=kw["block_m"],
            block_n=kw["block_n"], block_k=kw["block_k"],
            perfo=_jperfo(perfo, None if knob is None else 0.0),
            fraction=None if knob is None else jnp.float32(knob),
            rescale=kw["rescale"], interpret=True, pipeline=False)
        return (ref,), (pallas,)
    q, k, v = (_lane(a[n], lane, 4) for n in ("q", "k", "v"))
    dt = jnp.bfloat16 if case.dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(t, dt) for t in (q, k, v))
    rep = q.shape[1] // k.shape[1]
    perfo = kw["perfo"]
    ref = np.zeros(q.shape, np.float32) if every else jref.attention_ref(
        jq, jnp.repeat(jk, rep, 1), jnp.repeat(jv, rep, 1),
        causal=kw["causal"], block_kv=kw["block_kv"],
        perfo=_jperfo(perfo, knob))
    pallas = pallas_attention(
        jq, jk, jv, block_q=kw["block_q"], block_kv=kw["block_kv"],
        causal=kw["causal"],
        perfo=_jperfo(perfo, None if knob is None else 0.0),
        fraction=None if knob is None else jnp.float32(knob),
        interpret=True, pipeline=False)
    return (ref,), (pallas,)


@pytest.mark.parametrize("name", list(CASES))
def test_case_is_launchable(name):
    case = CASES[name]
    assert sanitize.launch_rule(case) is None
    assert set(sanitize.cuda_kernels(case)) <= set(sanitize.KERNELS)


@pytest.mark.parametrize("name", list(CASES))
def test_case_plain_matches_jax_oracle_and_pallas(name):
    case = CASES[name]
    port = _port(case)
    tol = ATOL.get(case.kernel, ATOL[case.dtype])
    for lane, knob in enumerate(_knobs(case)):
        ref, pallas = _oracles(case, lane, knob)
        for want in (ref, pallas):
            np.testing.assert_allclose(
                port[0][lane], np.asarray(want[0], np.float32), atol=tol,
                err_msg=f"{name} lane {lane}")
            if len(port) > 1:
                assert np.array_equal(port[1][lane], np.asarray(want[1])), \
                    f"{name} lane {lane}: mask differs"


def _mask(name):
    return sanitize.plain(CASES[name])[1]


def test_cases_reach_the_branches_they_name():
    # K1: rows that see no key give 0; every block dropped gives 0
    o = sanitize.plain(CASES["attn_rows_fully_masked"])[0]
    assert bool((o[..., :64, :] == 0).all()) and bool(o[..., 64:, :].any())
    assert not sanitize.plain(CASES["attn_all_dropped"])[0].any()
    # K2: some tiles stable, none stable; several slices a CTA; more units
    # than a team's worth of CTAs (132 co-resident at most, one an SM)
    assert _mask("taf_stable").any() and not _mask("taf_none_stable").any()
    assert taf_matmul.slices_per_cta(4096) > 1
    for name in ("taf_rounds", "taf_lanes_stacked_w_rounds"):
        case = CASES[name]
        bn = case.kwargs["block_n"]
        units = max(case.lanes, 1) * case.shapes()[1][1] // bn
        team = bn // taf_matmul.column_slice(bn)
        assert units * team > 2 * 132 and _mask(name).any()
    lanes = _mask("taf_lanes_shared")
    assert not lanes[0].any() and lanes[1].any()
    # K3: every block computes; some approximate; only block 0 computes
    assert not _mask("iact_all_compute").any()
    some = _mask("iact_some_approximate")
    assert some.any() and not some.all()
    only0 = _mask("iact_only_block_0")
    assert not only0[0] and only0[1:].all()
    # K4: every block dropped gives 0 whatever the rescale
    assert not sanitize.plain(CASES["pmm_all_dropped"])[0].any()


def test_every_kernel_and_tile_side_has_a_case():
    seen = {k for c in sanitize.CASES for k in sanitize.cuda_kernels(c)}
    assert seen == set(sanitize.KERNELS)
    attn = {(c.shapes()[0][3], c.dtype) for c in sanitize.CASES
            if c.kernel == "perforated_attention"}
    assert {(d, t) for d in (16, 32, 64, 128)
            for t in ("float32", "bfloat16")} <= attn
    sides = {c.kwargs[k] for c in sanitize.CASES
             if c.kernel == "perforated_matmul" for k in ("block_m", "block_n")}
    assert sides == {32, 64, 128}
    kinds = {(c.kwargs["perfo"].kind.value, c.knob is None)
             for c in sanitize.CASES if c.kwargs.get("perfo") is not None}
    for kind in ("ini", "fini", "random"):
        assert (kind, True) in kinds and (kind, False) in kinds
    assert ("small", True) in kinds and ("large", True) in kinds


@pytest.mark.parametrize("tool", sanitize.TOOLS)
def test_tool_runs_the_cases_on_the_cpu(tool):
    summary = sanitize.run_tool(tool, "cpu", log=lambda m: None)
    assert summary["errors"] == 0 and summary["cases"] == len(CASES)


def test_poison_fills_fences_and_finds_breaches():
    with sanitize.poisoned(0xFF, 0x7F) as poison:
        y = _build.empty((3, 5), torch.float32, "cpu", "y")
        assert bool(torch.isnan(y).all())
        x = poison.guarded(torch.arange(6, dtype=torch.int32), "x")
        assert x.tolist() == list(range(6))
        assert poison.breaches() == []
        raw, g, n, _ = poison.fences[0]
        raw[g + n] = 0       # one byte past y's end
        raw[g - 1] = 0       # one before
        found = poison.breaches()
        assert len(found) == 1 and "y: 2 guard bytes" in found[0]
        assert "[-1, 60]" in found[0]
    plain = _build.empty((2,), torch.float32, "cpu")
    assert plain.shape == (2,) and _build.allocator is None


def test_bit_comparison_and_disagreement():
    nan = torch.tensor([float("nan"), 1.0])
    assert sanitize.same_bits((nan,), (nan.clone(),))
    assert not sanitize.same_bits((nan,), (torch.tensor([0.0, 1.0]),))
    case = CASES["taf_stable"]
    want = sanitize.plain(case)
    assert sanitize.disagreement(case, want, want) is None
    flipped = (want[0], ~want[1])
    assert "mask" in sanitize.disagreement(case, flipped, want)
    off = (want[0] + 2e-3, want[1])
    assert "max_abs_err" in sanitize.disagreement(case, off, want)
    nans = (torch.full_like(want[0], float("nan")), want[1])
    assert sanitize.disagreement(case, nans, want) is not None


def test_checked_state_needs_the_checked_build():
    assert not _build._checked
    with pytest.raises(RuntimeError):
        sanitize.checked_state()
    assert _build.flags(True) == _build.NVCC_FLAGS + ["-DREPRO_SANITIZE"]
    assert _build.source_hash(True) != _build.source_hash()
    assert "-lineinfo" in _build.NVCC_FLAGS


def test_the_checks_reach_every_kernel_and_buffer():
    """`sanitize.KERNELS` names every `__global__` function of csrc/; every
    CTA barrier is `REPRO_SYNC()` (checked and jittered in the checked
    build); every source defines its checked-build entry point; every
    wrapper allocates its outputs and scratch through `_build.empty`."""
    import re
    from pathlib import Path
    sources = sorted(Path(_build.CSRC).glob("*.cu*"))
    text = "".join(p.read_text() for p in sources)
    names = re.findall(r"__global__\s+void\s+(?:__\w+__\s*\((?:[^()]|"
                       r"\([^()]*\))*\)\s*)*(\w+)\s*\(", text)
    assert sorted(set(names)) == sorted(sanitize.KERNELS)
    code = re.sub(r"//[^\n]*", "", text)
    assert code.count("__syncthreads()") == 1  # REPRO_SYNC's release form
    for src in _build.sources():
        assert f"REPRO_SANITIZE_ENTRY({src.stem})" in src.read_text()
    for mod in ("iact_memo", "perforated_attention", "perforated_matmul",
                "taf_matmul"):
        body = (Path(_build.CSRC).parent / f"{mod}.py").read_text()
        assert "torch.empty" not in body and "_build.empty(" in body
