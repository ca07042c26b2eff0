"""Shared pytest settings: registers the ``gpu`` marker only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA card (CUDA kernels); skips where there is none",
    )
