import pytest


@pytest.fixture(scope="session")
def bench_tmp(tmp_path_factory):
    """One directory for the session's model cache and runs."""
    return tmp_path_factory.mktemp("portbench")
