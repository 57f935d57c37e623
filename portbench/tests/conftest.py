"""The benchmark's own tests, run from the root of the checkout with
``python -m pytest portbench/tests -q``; the card's with ``-m cuda`` on a
machine that has one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
