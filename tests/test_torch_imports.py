"""Import hygiene of the PyTorch port: ``src/repro_torch`` and
``chip_smoke.py`` import neither jax nor the JAX package ``repro``, and
every CUDA source lives in ``src/repro_torch/kernels/csrc/``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "tests").glob("test_torch_cuda*.py")))
SKIP_DIRS = {".git", "build", "__pycache__"}


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    assert path.is_file(), path
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ):
            args = [a.value for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str)]
            bad += [a for a in args if _forbidden(a)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_card_reference_imports_jax_only_inside_main():
    """``tests/_card_reference.py`` is imported on the card, which has no
    jax: only its ``main()`` (which writes the fixture) may import it."""
    path = ROOT / "tests" / "_card_reference.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    outside = [n for n in tree.body if not (isinstance(n, ast.FunctionDef) and n.name == "main")]
    bad = [a.name for node in outside for n in ast.walk(node) if isinstance(n, ast.Import)
           for a in n.names if _forbidden(a.name)]
    bad += [n.module for node in outside for n in ast.walk(node)
            if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module and _forbidden(n.module)]
    assert not bad, bad
    inside = [n for n in ast.walk(next(n for n in tree.body if getattr(n, "name", "") == "main"))
              if isinstance(n, ast.Import) and any(_forbidden(a.name) for a in n.names)]
    assert inside, "main() writes the fixture with the reference"


def test_grid_tuning_and_experiments_are_checked():
    """The grid engine, the device transport plane, the tuning modules, the
    sweep harness with the engine benches and their runner, and the server
    optimizers are among the files held to the rule above."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    want = {"core/grid.py", "transport/plane.py", "tuning/__init__.py", "tuning/grid.py",
            "tuning/daemon.py", "experiments/__init__.py", "experiments/common.py"}
    want |= {f"experiments/{m}.py" for m in (
        "fig3_latency", "fig4_loss", "fig5_client_failure", "table3_boundaries",
        "tuned_vs_default", "fig678_tcp_params", "adaptive_daemon", "env_profiles",
        "reliability_bench", "resilience_bench", "transport_plane_bench",
        "round_engine_bench", "sweep_bench", "compress_bench", "run")}
    want |= {"optim/optimizers.py", "core/strategy.py"}
    assert want <= names, want - names


def test_forbidden_names_are_caught():
    assert _forbidden("jax.numpy") and _forbidden("repro.core") and _forbidden("repro")
    assert not _forbidden("repro_torch.core") and not _forbidden("torch")


def test_cuda_sources_live_in_the_port_csrc():
    csrc = PORT / "kernels" / "csrc"
    found = [
        p for ext in ("*.cu", "*.cuh") for p in ROOT.rglob(ext)
        if not SKIP_DIRS.intersection(p.relative_to(ROOT).parts)
    ]
    assert found, "the port ships at least one CUDA source"
    outside = [str(p.relative_to(ROOT)) for p in found if p.parent != csrc]
    assert not outside, outside
