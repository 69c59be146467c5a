import os
import sys

# Tests run the pure-jnp reference path by default (fast on 1 CPU core);
# kernel tests opt into Pallas interpret mode explicitly.
os.environ.setdefault("REPRO_PALLAS", "ref")
# NEVER set xla_force_host_platform_device_count here — smoke tests must
# see exactly 1 device (the dry-run owns the 512-device override).

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: needs an sm_90 CUDA card; skipped elsewhere")
