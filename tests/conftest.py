def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end serving test")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one (run on the "
                   "card with `pytest -m gpu tests/test_torch_*.py`)")
