import os
import sys

# tests run with PYTHONPATH=src; this makes them work standalone too.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Keep smoke tests on 1 device — the dry-run (and only the dry-run) forces
# 512 host devices in its own process.
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: k-means / IVF fit-heavy tests, excluded from the CI fast "
        "lane (-m 'not slow'); the full tier-1 run still includes them")
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips itself without one "
        "(run on the card with -m chip, in files that import no JAX)")
