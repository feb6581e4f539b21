"""Nothing the benchmark's runs load is JAX, jaxlib or the JAX package
(top-level names compared whole), and the reference loads nothing of the
program."""

import ast
import subprocess
import sys
import textwrap

from hgbench.lib import names

FORBIDDEN = {"jax", "jaxlib", "flax", "hectorgrapher_tpu"}


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_of_the_benchmark_names_jax():
    for path in names.HGBENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _top_level_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (names.HGBENCH / "reference").glob("*.py"):
        assert not _top_level_imports(path) & (FORBIDDEN | {"hectorgrapher_tpu_torch"}), path
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(names.ROOT)!r})
        import hgbench.reference.ct_window, hgbench.reference.insert_3d
        import hgbench.reference.scan_2d, hgbench.reference.spa_2d
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"hectorgrapher_tpu_torch"})


def test_a_run_loads_no_jax():
    """A whole run of a cell on the CPU at a test's size, its comparison
    included, then the loaded modules' top-level names."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(names.ROOT)!r})
        sys.path.insert(0, {str(names.HGBENCH / "tests")!r})
        import hgbench.run
        import tiny
        tiny.run("drz_ct3d.solo", 11, 2.0, trace=True)
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "hectorgrapher_tpu_torch" in loaded and not loaded & FORBIDDEN
