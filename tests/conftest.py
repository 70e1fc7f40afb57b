"""Test configuration: force CPU with 8 virtual devices so multi-device
sharding paths are testable without an accelerator (SURVEY.md §4).

- jax.config.update('jax_platforms', 'cpu') holds the tests to the CPU
  whatever accelerator plugin the interpreter has;
- jax's backend must initialize BEFORE cv2 is imported anywhere, otherwise
  the cv2 OpenMP runtime deadlocks the XLA CPU client threadpool startup.
  Importing jax here (conftest imports run first) guarantees the order.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
_ = jax.devices()  # initialize the CPU client now, before any cv2 import

import os  # noqa: E402
import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Build the native loader if missing so its tests run in the standard
# invocation instead of skipping (VERDICT r03 hygiene item).
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_REPO, "svo_tpu", "runtime", "libsvoloader.so")
if not os.path.exists(_SO):
    try:
        subprocess.run(
            ["make", "-C", os.path.join(_REPO, "native")],
            check=True, capture_output=True, timeout=120,
        )
    except Exception:
        pass  # tests fall back to their skipif guard


@pytest.fixture
def rng():
    return np.random.default_rng(42)
