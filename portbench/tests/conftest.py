"""The benchmark's tests: ``python -m pytest portbench/tests -q`` from the
root of the repository (``-m cuda`` on the card for the tests that need
it)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
