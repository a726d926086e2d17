"""Shared pytest configuration for the repro test-suite."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute subprocess compile tests (deselect with "
        "-m 'not slow')")
    config.addinivalue_line(
        "markers",
        "property: hypothesis state-machine suites (CI re-runs them with "
        "a fixed seed and a higher example count)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels); "
        "skips without one")
