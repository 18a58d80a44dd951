"""The harness's CPU tests: ``python -m pytest h100bench/tests`` from the
repository root. The port is imported from ``src/`` as the harness itself
imports it."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

# The small cells' windows are timed by the wall clock: one thread a test
# process keeps a step from waiting on threads that a busy host has parked.
torch.set_num_threads(1)
