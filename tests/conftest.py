import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    # pytest.ini sets a per-test ceiling via pytest-timeout; register the
    # marker here too so per-test `@pytest.mark.timeout(...)` overrides do
    # not warn when the plugin is absent (bare containers).
    config.addinivalue_line(
        "markers", "timeout(seconds): per-test ceiling (pytest-timeout)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")
