"""The thread policy of the port's CPU tests, defined once.

Every `tests/test_torch_port_*.py` takes it with
`from torch_threads import one_torch_thread`.  The bare name resolves
through the test directory, which pytest's default import mode puts on
`sys.path`; `tests.torch_threads` would not where an installed package is
also named `tests`."""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch in an xdist worker, for the module's
    tests; the previous count comes back at teardown, so other modules in the
    same worker keep theirs.

    The Tier-1 run puts 6 xdist workers on an 8-core machine, and torch opens
    a thread pool as wide as the machine in each: the workers spend more time
    contending than computing.  Run alone with those flags, the two train
    files (`test_torch_port_train_step.py`, `test_torch_port_trainer.py`)
    took 539.5 s of wall time as they were, 90.3 s at one thread.

    Outside xdist (a file run by hand, the card's run of
    `test_torch_port_cuda.py`) the process has the machine to itself and
    keeps all its threads."""
    threads = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
