"""Tests of the benchmark harness.  They run on the CPU at small sizes; the
one test marked ``card`` runs a cell on an NVIDIA card and skips without
one:

    python -m pytest mebench/tests -q            # here, on the CPU
    python -m pytest mebench/tests -q -m card    # on the card
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs a benchmark cell on an NVIDIA card; skips without one")
