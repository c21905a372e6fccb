"""Test support for the port's CPU tests. A test file takes the fixture by
importing it:

    from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs at small shapes, where one thread is about as
    fast as a pool; under the suite's parallel workers, which share the
    host's cores, an oversubscribed pool slows small ops 10-25x."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
