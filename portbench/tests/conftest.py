"""Fixtures of the benchmark's own tests: a tiny checkout on the CPU."""
import pytest

from portbench.tests import tiny


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """``(root, here)`` of the two cells at a size the CPU runs."""
    return tiny.make(str(tmp_path_factory.mktemp("portbench")))


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    """``(root, here)`` at the train cell's widths on a small graph."""
    return tiny.make(str(tmp_path_factory.mktemp("portbench_small")),
                     tiny.SMALL_GRAPH, {}, tiny.SMALL_MIX)
