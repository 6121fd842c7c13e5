import os
import sys

# NOTE: do NOT set --xla_force_host_platform_device_count here — smoke
# tests and benches must see 1 device.  Multi-device distributed tests run
# in subprocesses (tests/helpers/).
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; the test skips itself "
        "when torch.cuda.is_available() is False")
