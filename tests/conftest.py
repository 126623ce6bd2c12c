def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (a kernel with no CPU mode); "
        "skips without one")
