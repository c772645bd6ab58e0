"""The benchmark's tests: small shapes on the CPU; ``gpu`` marks a test
that needs a CUDA card and skips inside the test without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips inside the test without "
        "one)")
