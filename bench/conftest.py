"""pytest set-up of the benchmark's own tests (``python -m pytest bench/tests``).

Puts ``bench/`` and ``src/`` on the import path, and registers the marker
``chip`` for tests that need a CUDA device: each decides inside the test
whether there is one, and skips on a machine without."""
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH / "tests"), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def toy(tmp_path_factory):
    """The toy cell's root (``tests/helpers.make_toy``)."""
    from helpers import make_toy
    return make_toy(tmp_path_factory.mktemp("toy"))
