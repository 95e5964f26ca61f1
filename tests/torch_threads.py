"""One intra-op thread for the port's CPU tests. The tier-1 run starts several
pytest workers on the same cores; torch's OpenMP pool (a thread per core in
every worker) then spins against the other workers, and the plain versions'
many small tensor ops run 10 to 100 times slower. A test module that imports
``one_intra_op_thread`` runs on one thread and restores the count after it."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
