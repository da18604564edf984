"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Modules are compared by their
top-level name (before the first dot), whole: texturefusion_torch is not
texturefusion_tpu."""

import ast
import os
import subprocess
import sys

from tfbench import harness

JAX = {"jax", "jaxlib", "flax", "texturefusion_tpu"}
PROGRAM = {"texturefusion_torch"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts):
    root = os.path.join(harness.HERE, *parts)
    for d, _, files in os.walk(root):
        if os.path.basename(d) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_of_the_benchmark_imports_jax():
    for path in _sources():
        assert not (_imports(path) & JAX), path


def test_reference_and_generator_import_nothing_of_the_program():
    for path in list(_sources("reference")) + list(_sources("traffic")):
        assert not (_imports(path) & (PROGRAM | JAX)), path


def test_a_run_loads_no_jax_module():
    # what a run imports, in a fresh interpreter: the harness, the
    # program's modules it drives, every reader
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from tfbench import harness, session, trace, control\n"
            "from tfbench.traffic import generator\n"
            "from tfbench.reference import check\n"
            "session.pipeline_class('TexturedPipeline')\n"
            "harness.graph_programs(); harness.k2_counters()\n"
            "b = harness.load_json(harness.ROOT, 'BENCHMARK.json')\n"
            "[harness.load_reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
            "print(' '.join(harness.forbidden_modules()))\n" % harness.ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    assert out.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "texturefusion_tpu_like", object())
    assert "texturefusion_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()
