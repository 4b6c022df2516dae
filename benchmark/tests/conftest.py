"""The benchmark's own tests (run with ``python -m pytest benchmark/tests``
from the root of a checkout): CPU tests at the tiny presets, and tests
marked ``chip`` that need a card and skip without one."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")
