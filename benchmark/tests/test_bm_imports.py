"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program: top-level module names
are compared whole, since `altro_tpu_torch` begins with `altro_tpu`."""
import ast
import subprocess
import sys

from benchmark.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "altro_tpu"}


def _imports(path):
    """(top-level name, relative level) of every import in a file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or "").split(".")[0], node.level))
    return out


def _files(*dirs):
    return [p for d in dirs for p in (spec.ROOT / d).rglob("*.py") if "tests" not in p.relative_to(spec.ROOT).parts[1:2]]


def test_no_file_run_reaches_imports_jax():
    files = _files("benchmark", "altro_tpu_torch")
    assert len(files) > 40
    bad = [(str(p), name) for p in files for name, level in _imports(p) if level == 0 and name in FORBIDDEN]
    assert not bad, bad


def test_reference_imports_nothing_of_the_program():
    for p in (spec.BENCH_DIR / "reference").rglob("*.py"):
        for name, level in _imports(p):
            assert level <= 1, (p, name)  # only its own modules
            assert name != "altro_tpu_torch" and name not in FORBIDDEN, (p, name)


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_loaded_modules():
    every = _loaded(
        "import sys, glob, os\n"
        "from benchmark.harness import runner, spec\n"
        "import altro_tpu_torch, altro_tpu_torch.solver.compaction, altro_tpu_torch.solver.mpc\n"
        "[spec.load_module('metrics', os.path.basename(p)[:-3]) for p in glob.glob('benchmark/metrics/*.py')]\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    assert "altro_tpu_torch" in every and not every & FORBIDDEN, every & FORBIDDEN
    ref = _loaded(
        "import sys, glob, os\n"
        "import benchmark.reference.altro, benchmark.reference.problem\n"
        "from benchmark.reference import constraints, models\n"
        "[models.dynamics(os.path.basename(p)[:-3]) for p in glob.glob('benchmark/reference/models/[!_]*.py')]\n"
        "[constraints.kind(os.path.basename(p)[:-3]) for p in glob.glob('benchmark/reference/constraints/[!_]*.py')]\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    assert "altro_tpu_torch" not in ref and not ref & FORBIDDEN
