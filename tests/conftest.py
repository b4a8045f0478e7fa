import os
import sys

# tests run on the default single CPU device (the dry-run's 512-device
# override is local to repro/launch/dryrun.py; multi-device checks run in
# a subprocess — see test_distributed.py).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax

jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card and nvcc; skips without them")
