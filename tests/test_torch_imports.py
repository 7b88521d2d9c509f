"""Import hygiene of the port: unipose_tpu_torch, chip_smoke.py and the
data-parallel rank worker import neither jax nor the JAX package, and its
entry points never fall back to the CPU on their own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "unipose_tpu_torch"
FORBIDDEN = ("jax", "unipose_tpu", "flax", "jaxlib")


def _modules():
    names = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return names


def _sources():
    # the data-parallel rank worker runs as a child process of the tests
    # and of chip_smoke.py, on the card's host too
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_ddp_worker.py"]


def _forbidden(module: str) -> bool:
    """Matches a forbidden top-level package exactly: 'unipose_tpu' and
    'unipose_tpu.x' do, 'unipose_tpu_torch' does not."""
    return module.split(".")[0] in FORBIDDEN


def test_forbidden_matches_whole_names():
    assert _forbidden("unipose_tpu.models.wasp") and _forbidden("jax.numpy")
    assert not _forbidden("unipose_tpu_torch.models.wasp") and not _forbidden("jaxtyping")


def test_the_scans_reach_the_time_parallel_module():
    """parallel/cp.py (time parallelism) is imported by the subprocess and
    scanned by the AST check below, as every module of the port is."""
    assert "unipose_tpu_torch.parallel.cp" in _modules()
    assert PORT / "parallel" / "cp.py" in _sources()


def test_importing_the_port_loads_no_jax():
    mods = _modules() + ["chip_smoke"]
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str) and _forbidden(arg.value):
                bad.append(arg.value)
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_raise_without_a_card(monkeypatch):
    from unipose_tpu_torch import resolve_device
    from unipose_tpu_torch.cli import serve
    from unipose_tpu_torch.core.config import ModelConfig, TrainConfig
    from unipose_tpu_torch.data.synthetic import make_loaders
    from unipose_tpu_torch.models.unipose import init_model
    from unipose_tpu_torch.train.state import create_train_state
    from unipose_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(ModelConfig(), seed=0, layers=(1, 1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(ModelConfig(variant="lstm", num_classes=13), seed=0, layers=(1, 1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.make_server(serve.parse_args(["--port", "0"]))
    for extra in ([], ["--stream"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.make_server(serve.parse_args(
                ["--port", "0", "--dataset", "Penn_Action", "--model_arch", "uniposeLSTM"] + extra))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(ModelConfig(), TrainConfig(), seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ModelConfig(), TrainConfig(), loaders=make_loaders("image", train_samples=1, val_samples=1))
    assert resolve_device("cpu") == torch.device("cpu")
