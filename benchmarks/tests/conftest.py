"""The benchmark's own tests: CPU only, small sizes. Run from the
repository's root: ``python -m pytest benchmarks/tests -q``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
