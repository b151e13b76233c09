"""pytest settings of the benchmark's tests: the ``card`` marker for tests
that need an NVIDIA card (they skip without one, decided inside the test)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")
