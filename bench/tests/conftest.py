"""The benchmark's CPU tests: the checkout root and ``src/`` on the import
path (the driver's test run does not collect this folder)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
