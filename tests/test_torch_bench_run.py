"""The port's benchmark runner (`repro_torch.benchmarks.run`): module
selection, `--substrate` fail-fast, ERROR rows and exit codes, the
regression gate, and the committed H100 baselines, on the CPU.

The gate's rules for BENCH_ffn.json are the JAX runner's, so on the same
artifact / baseline pair both gates must give the same failures. The
gate's tolerances are the JAX runner's defaults (rtol 0.25, atol 0.05,
noise 0.8) and are not tightened here.
"""
import json
import os
import shutil
import sys

import pytest

from repro_torch.benchmarks import run

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)                            # benchmarks package
sys.path.insert(0, os.path.join(REPO, "examples"))  # apps package
from benchmarks import run as jrun  # noqa: E402

JAX_FFN = os.path.join(REPO, "benchmarks", "baselines", "BENCH_ffn.json")


def _write(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f)


@pytest.fixture
def dirs(tmp_path):
    """A baseline dir holding the committed H100 baselines, and an artifact
    dir holding copies of them (a run that reproduces them exactly)."""
    base, art = tmp_path / "base", tmp_path / "art"
    shutil.copytree(run.BASELINES, base)
    shutil.copytree(run.BASELINES, art)
    return str(base), str(art)


def _edit(path, dotted, value):
    with open(path) as f:
        doc = json.load(f)
    cur = doc
    *parents, last = dotted.split(".")
    for p in parents:
        cur = cur[p]
    cur[last] = value
    _write(path, doc)


def test_gate_passes_on_the_baselines_themselves(dirs):
    base, art = dirs
    assert run.check_regression(art, base) == []
    assert sorted(os.listdir(base)) == ["BENCH_costmodel.json",
                                        "BENCH_ffn.json", "BENCH_kernel.json"]


@pytest.mark.parametrize("artifact,key,value,rule", [
    ("BENCH_ffn.json", "parity.iact", False, "expected True, got False"),
    ("BENCH_kernel.json", "geometry", "ref", "expected 'full', got 'ref'"),
    ("BENCH_ffn.json", "front.hypervolume", 0.5, "vs baseline 0.79"),
    ("BENCH_kernel.json", "executed_grid_fraction.iact", "x",
     "non-numeric"),
    ("BENCH_kernel.json", "tuning.perforated_attention.speedup", 0.1,
     "below 20% of baseline"),
])
def test_gate_catches_exact_close_and_atleast(dirs, artifact, key, value,
                                              rule):
    base, art = dirs
    _edit(os.path.join(art, artifact), key, value)
    fails = run.check_regression(art, base)
    assert len(fails) == 1 and fails[0].startswith(f"{artifact}:{key}:")
    assert rule in fails[0]


def test_gate_close_and_atleast_keep_their_margins(dirs):
    base, art = dirs
    with open(os.path.join(base, "BENCH_ffn.json")) as f:
        hv = json.load(f)["front"]["hypervolume"]
    # within atol 0.05 + rtol 0.25: passes; a 5x slowdown of a wall ratio
    # is the edge of the noise margin
    _edit(os.path.join(art, "BENCH_ffn.json"), "front.hypervolume",
          hv + 0.04)
    with open(os.path.join(base, "BENCH_kernel.json")) as f:
        sp = json.load(f)["tuning"]["perforated_attention"]["speedup"]
    _edit(os.path.join(art, "BENCH_kernel.json"),
          "tuning.perforated_attention.speedup", 0.2 * sp)
    assert run.check_regression(art, base) == []


def test_gate_reports_missing_and_unreadable_artifacts(dirs):
    base, art = dirs
    os.remove(os.path.join(art, "BENCH_ffn.json"))
    with open(os.path.join(art, "BENCH_kernel.json"), "w") as f:
        f.write("{not json")
    fails = run.check_regression(art, base)
    assert len(fails) == 2
    assert fails[0].startswith("BENCH_ffn.json: baseline committed but no "
                               "fresh artifact")
    assert fails[1].startswith("BENCH_kernel.json: fresh artifact "
                               "unreadable (JSONDecodeError")


def test_gate_refuses_a_baseline_with_no_rule(dirs, tmp_path):
    base, art = dirs
    _write(os.path.join(base, "BENCH_qos.json"), {"metric": "qos"})
    _write(os.path.join(art, "BENCH_qos.json"), {"metric": "qos"})
    fails = run.check_regression(art, base)
    assert fails == ["BENCH_qos.json: no check rules registered in "
                     "repro_torch.benchmarks.run._BASELINE_CHECKS"]
    empty = tmp_path / "empty"
    empty.mkdir()
    for missing in (str(empty), str(tmp_path / "nowhere")):
        assert run.check_regression(art, missing) == [
            f"no BENCH_*.json baselines found under {missing}"]


def test_ffn_gate_agrees_with_the_jax_gate(tmp_path):
    """The same ffn artifact / baseline pairs through both gates."""
    base, art = tmp_path / "base", tmp_path / "art"
    base.mkdir()
    art.mkdir()
    shutil.copy(os.path.join(run.BASELINES, "BENCH_ffn.json"), base)
    shutil.copy(os.path.join(run.BASELINES, "BENCH_ffn.json"), art)
    for key, value in ((None, None), ("n_records", 29),
                       ("front.best_error", 0.5), ("substrate", "host")):
        if key:
            _edit(str(art / "BENCH_ffn.json"), key, value)
        assert run.check_regression(str(art), str(base)) == \
            [f.replace("benchmarks.run.", "repro_torch.benchmarks.run.")
             for f in jrun.check_regression(str(art), str(base))]


def test_committed_baselines_name_an_h100_and_hold_the_jax_front():
    for name in ("BENCH_ffn.json", "BENCH_kernel.json"):
        with open(os.path.join(run.BASELINES, name)) as f:
            doc = json.load(f)
        assert doc["card"].startswith("NVIDIA H100")
        assert doc["card"].endswith(" W")
        for key in run._BASELINE_CHECKS[name]["exact"]:
            assert run._lookup(doc, key) is not None, key
    with open(os.path.join(run.BASELINES, "BENCH_kernel.json")) as f:
        kernel = json.load(f)
    assert (kernel["substrate"], kernel["geometry"]) == ("cuda", "full")
    assert kernel["device"].startswith("NVIDIA H100")
    with open(os.path.join(run.BASELINES, "BENCH_ffn.json")) as f:
        ffn = json.load(f)
    with open(JAX_FFN) as f:
        jax_ffn = json.load(f)
    assert ffn["substrate"] == "cuda"
    assert ffn["front"]["n_front"] == jax_ffn["front"]["n_front"] == 4
    assert abs(ffn["front"]["hypervolume"]
               - jax_ffn["front"]["hypervolume"]) <= 1e-4
    assert ffn["n_records"] == jax_ffn["n_records"]


@pytest.mark.parametrize("only,message", [
    ("fig3,fig99", "unknown module 'fig99'"),
    ("qos", "module 'qos' is not ported yet (ROADMAP Queue 1 item 4"),
    ("fig3,obs", "module 'obs' is not ported yet"),
    ("lint", "Queue 1 item 7"),
    ("roofline", "Queue 1 item 6"),
    ("obs", "Queue 1 item 4"),
])
def test_only_refuses_unknown_and_jax_only_keys(capsys, only, message):
    with pytest.raises(SystemExit) as e:
        run.main(["--device", "cpu", "--only", only])
    assert e.value.code == 2
    assert message in capsys.readouterr().err
    assert set(run.NOT_PORTED) == set(jrun.MODULES) - set(run.MODULES)


@pytest.mark.parametrize("substrate,only,deaf", [
    ("host", "kernel", "kernel"), ("cuda", "fig3,ffn,pareto", "fig3,pareto"),
    ("cuda", "kernel,fig10c", "fig10c")])
def test_substrate_fails_fast_in_both_directions(capsys, substrate, only,
                                                 deaf):
    with pytest.raises(SystemExit) as e:
        run.main(["--device", "cpu", "--substrate", substrate, "--only",
                  only])
    assert e.value.code == 2
    assert f"--substrate {substrate} cannot be honored by {deaf}:" in \
        capsys.readouterr().err
    support = run.substrate_support()
    assert support["ffn"] == {"host", "cuda"} and support["kernel"] == \
        {"cuda"} and support["fig12c"] == {"host"}


def test_check_regression_needs_artifacts(capsys):
    with pytest.raises(SystemExit):
        run.main(["--device", "cpu", "--check-regression", run.BASELINES])
    assert "--check-regression needs --artifacts" in capsys.readouterr().err


def test_a_module_that_raises_is_an_error_row_and_exit_1(monkeypatch,
                                                         capsys):
    def boom(report, device=None):
        raise ValueError("planted")

    monkeypatch.setattr(run.MODULES["fig3"], "main", boom)
    assert run.main(["--device", "cpu", "--only", "fig3,pareto"]) == 1
    out = capsys.readouterr()
    assert "fig3,ERROR,ValueError: planted" in out.out
    assert "pareto_refine,refined_front,n=6/12" in out.out  # still ran
    assert "modules failed: fig3" in out.err


def test_runner_runs_and_gates_on_the_cpu(tmp_path, capsys):
    """`--only ffn` on the CPU writes BENCH_ffn.json; gated against the
    ffn baseline alone it passes (the front is machine-independent), and
    against a planted departure it exits 2."""
    art = str(tmp_path / "art")
    base = os.path.join(run.BASELINES, "BENCH_ffn.json")
    trace = str(tmp_path / "trace.json")
    assert run.main(["--device", "cpu", "--only", "ffn", "--artifacts", art,
                     "--check-regression", base, "--trace", trace]) == 0
    out = capsys.readouterr().out
    assert "regression,OK," in out
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "bench.ffn" in names
    _edit(os.path.join(art, "BENCH_ffn.json"), "parity.taf", False)
    assert run.check_regression(art, base) == [
        "BENCH_ffn.json:parity.taf: expected True, got False"]
