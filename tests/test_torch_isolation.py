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


NEW_FIGURES = ("fig3_table_memory", "fig8c_items_per_thread",
               "fig10c_rsd_behavior", "fig11c_hierarchy",
               "fig12c_kmeans_convergence", "pareto_refine")


@pytest.mark.parametrize("name", NEW_FIGURES)
def test_new_figures_default_to_cuda(no_gpu, name):
    import importlib
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(report=lambda *a: None)


def test_quickstart_and_runner_default_to_cuda(no_gpu, capsys):
    from repro_torch import quickstart
    from repro_torch.benchmarks import fig3_table_memory, run
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main()
    # the runner turns the module's refusal into an ERROR row and exit 1
    assert run.main(["--only", "fig3"]) == 1
    assert "fig3,ERROR,RuntimeError: no CUDA device" in capsys.readouterr().out
    assert run.main(["--only", "fig3", "--device", "cpu"]) == 0
    rows = fig3_table_memory.main(report=lambda *a: None, device="cpu")
    assert rows["memory"]["bytes"] == fig3_table_memory.H100_TOTAL_MEMORY


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


def test_serving_entry_points_default_to_cuda(no_gpu, capsys):
    """The serving slice's entry points: `launch.serve`, `build(...)`
    (and so `.init` and `ServingEngine`), `make_decode_app` and the `qos`
    / `obs` runner modules run on cuda unless asked for the CPU."""
    from repro_torch.benchmarks import obs_overhead, qos_serving
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.qos import default_decode_cfg, make_decode_app
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-1.7b", "--smoke", "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_decode_app()
    for mod in (qos_serving, obs_overhead):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(lambda *a: None)
    model = build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert params["embed"].device.type == "cpu"
    eng = ServingEngine(model, params, slots=2, max_len=16, prompt_len=4)
    assert eng.tokens.device.type == "cpu"
    app = make_decode_app(default_decode_cfg(), gen=2, batch=1,
                          device="cpu")
    assert app.exact().qoi.shape[0] == 2
    toks = serve.main(["--arch", "qwen3-1.7b", "--smoke", "--gen", "2",
                       "--prompt-len", "4", "--device", "cpu"])
    assert toks.shape == (4, 2)
    capsys.readouterr()


def test_training_entry_points_default_to_cuda(no_gpu, tmp_path, capsys):
    """The training half's entry points -- `launch.train`, the 100M
    example, `Model.masters` (through `build`), `convert.lm_params(...,
    masters=True)` and `convert.adamw_state` -- run on cuda unless asked
    for the CPU; the optimizer, schedules, data, checkpoints and specs
    follow the tensors they are given (specs: the meta device)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.examples import train_100m
    from repro_torch.launch import specs
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build
    from repro_torch.optim import adamw
    args = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "2", "--batch",
            "2", "--seq-len", "8", "--log-every", "100"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.main(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_100m.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    cfg = get_smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg).masters(torch.Generator().manual_seed(0))
    model = build(cfg, device="cpu")
    masters = model.masters(torch.Generator().manual_seed(0))
    jax_like = {"embed": np.zeros((4, 2), np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_params(jax_like, cfg, masters=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.adamw_state(adamw.AdamWState(np.int32(0), jax_like,
                                             jax_like), cfg)
    state = adamw.init(masters)
    assert state.step.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in adamw.leaves(state.m))
    meta = specs.train_batch_specs(cfg, ShapeConfig("t", 8, 2, "train"))
    assert all(t.device.type == "meta" for t in meta.values())
    assert len(train_mod.main(args + ["--device", "cpu"])) == 2
    capsys.readouterr()
