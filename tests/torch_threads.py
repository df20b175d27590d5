"""One torch intra-op thread for a test module (helper of the ``test_torch_*``
files whose work is many small tensor operations).

Under the tier-1 command six xdist workers share the machine's cores, and
each worker's torch opens one intra-op thread per core: loops over small
tensors (UMAP epochs, t-SNE iterations, tiny train steps) then spend their
time waiting on each other's threads. A module that imports
``one_torch_thread`` runs with one thread and restores the count after it::

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
