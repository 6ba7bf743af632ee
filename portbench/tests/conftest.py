"""The benchmark's own tests: run with ``python -m pytest portbench/tests``
from the repository's root (they import ``portbench`` and
``grafx_tpu_torch`` from there, and never JAX)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
