"""The benchmark's CPU tests: put the checkout's root and ``src`` on the
path, as ``bench/run.py`` does, so ``bench`` and ``repro_torch`` import."""
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
for p in (str(_ROOT / "src"), str(_ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
