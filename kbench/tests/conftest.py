"""The kbench tests: CPU tests of the harness at tiny sizes, and tests
marked ``card`` that need the H100 and skip elsewhere (each decides inside
the test, never while the module is imported)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (runs on the H100; skips "
        "elsewhere)")
