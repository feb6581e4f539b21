"""The benchmark's own tests: `python -m pytest hgbench/tests -q` from the
repository's root. They run on the CPU; a test marked `chip` needs a CUDA
card and skips without one (decided inside its fixture)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")
