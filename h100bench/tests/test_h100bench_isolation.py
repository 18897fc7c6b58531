"""What the benchmark may load: no module under ``h100bench/`` imports JAX
or the JAX package (top-level names compared whole: the port,
``repro_torch``, begins with ``repro``), and the reference imports nothing
of the port."""
import ast
import subprocess
import sys
from pathlib import Path

from h100bench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports (absolute imports)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _sources():
    return sorted(p for p in spec.BENCH.rglob("*.py") if "tests" not in p.parts)


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    assert len(_sources()) > 10
    for p in _sources():
        bad = _imports(p) & FORBIDDEN
        assert not bad, f"{p} imports {bad}"


def test_the_names_are_compared_whole():
    assert "repro_torch" not in FORBIDDEN and "repro_torch".split(".")[0] != "repro"


def test_the_reference_imports_torch_alone():
    for p in (spec.BENCH / "reference").rglob("*.py"):
        assert _imports(p) <= {"__future__", "math", "typing", "torch"}, p


def test_a_run_loads_no_jax(tmp_path):
    """The port's serving path, imported and built as a run builds it,
    leaves no forbidden module in ``sys.modules``."""
    code = f"""
import sys
sys.path[:0] = [{str(spec.ROOT)!r}, {str(spec.ROOT / 'src')!r}]
sys.argv = ['x']
from h100bench import run
from h100bench.harness import program, runner, spec
cell = spec.load_cell('internlm2-20b.chat')
program.port_config(cell.config)
import repro_torch.launch.serve
bad = run.forbidden_loaded()
print(bad)
sys.exit(1 if bad else 0)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                                         "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stdout + r.stderr


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    """Without a CUDA card, and in a directory that holds only
    ``BENCHMARK.json`` and the benchmark, a run prints no result and exits
    non-zero."""
    import shutil

    shutil.copytree(spec.BENCH, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    for root in (spec.ROOT, tmp_path):
        r = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                            "internlm2-20b.chat", "--seed", "2147483659", "--seconds", "1",
                            "--trace", "0"], cwd=root, capture_output=True, text=True,
                           timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                                             "CUDA_VISIBLE_DEVICES": ""})
        assert r.returncode != 0
        assert r.stdout.strip() == "", r.stdout
