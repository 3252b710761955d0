"""pytest settings of the benchmark's own tests (``python3 -m pytest slambench -q``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips, with its reason, on a machine without one")
