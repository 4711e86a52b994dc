"""GPU device tier: the CPU suite's key differentials, run on the card.

Unlike tests/ (which forces an 8-device virtual CPU mesh), this tier runs
on the GPU so the device numerics — explicit precision on every product,
XLA's GPU lowering of the fleet steps — are covered by tests and not
only by chip_smoke.py's phases.  Every test is marked ``gpu``; the
``_needs_gpu`` fixture skips it, with its reason, unless JAX's default
device is a GPU.  The decision is made at test time, never while a
module is imported.

Run on a GPU host:  python chip_smoke.py  (phase 6 runs this tier in
process), or  python -m pytest tests_gpu -q
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent.parent))
sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))


@pytest.fixture(autouse=True)
def _needs_gpu():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"GPU device tier: JAX's default device is {platform!r}")
