"""The port stands alone: no JAX and nothing of the JAX package, entry points
that run on cuda unless asked for the CPU, and a smoke script that refuses
to run without a card or outside a checkout."""
import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert, device
from repro_torch.apps import approx_ffn
from repro_torch.benchmarks import approx_ffn_sweep

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(REPO, "src", "repro_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _port_files():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield SMOKE


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", list(_port_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{os.path.relpath(path, REPO)} imports {mod}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_one(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve()
    with pytest.raises(RuntimeError):
        approx_ffn.make_app()
    with pytest.raises(RuntimeError):
        approx_ffn_sweep.main(report=lambda *a: None)
    with pytest.raises(RuntimeError):
        convert.ffn_arrays(*approx_ffn.host_arrays(32, 8, 16, 0))


HPC_APPS = ("blackscholes", "binomial_options", "kmeans", "lavamd",
            "minife_cg")


@pytest.mark.parametrize("name", HPC_APPS)
def test_hpc_apps_default_to_cuda(no_gpu, name):
    import importlib
    mod = importlib.import_module(f"repro_torch.apps.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.make_app()
    assert mod.make_app(device="cpu").run is not None


def test_figures_and_regions_default_to_cuda(no_gpu):
    from repro_torch.benchmarks import fig6_best_speedup, fig7_cg_sweep
    from repro_torch.core import ApproxRegion, ApproxSpec, Technique
    with pytest.raises(RuntimeError):
        fig6_best_speedup.main(report=lambda *a: None, apps=["kmeans"])
    with pytest.raises(RuntimeError):
        fig7_cg_sweep.main(report=lambda *a: None)
    region = ApproxRegion(ApproxSpec(Technique.TAF), lambda: None,
                          n_elements=4)
    with pytest.raises(RuntimeError):
        region.init_state()
    state = ApproxRegion(ApproxSpec(Technique.TAF), lambda: None,
                         n_elements=4, device="cpu").init_state()
    assert state.memo.device.type == "cpu"


def test_cpu_is_taken_only_when_asked(no_gpu):
    assert device.resolve("cpu").type == "cpu"
    x = convert.ffn_arrays(*approx_ffn.host_arrays(32, 8, 16, 0),
                           device="cpu")[0]
    assert x.device.type == "cpu" and x.dtype == torch.float32
    with pytest.raises(ValueError):
        device.resolve("meta")


def _run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_smoke_fails_without_a_card():
    out = _run_smoke(REPO, SMOKE)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_smoke_fails_outside_a_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, lone)
    out = _run_smoke(str(tmp_path), str(lone))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_convert_copies():
    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    t = convert.to_tensor(a, "cpu")
    a[0, 0] = 99.0
    assert t.dtype == torch.float32 and float(t[0, 0]) == 0.0
