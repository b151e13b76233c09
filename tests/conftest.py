import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running scenario/compile tests")
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")
