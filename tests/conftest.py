def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an sm_90 CUDA card; skips without one")
