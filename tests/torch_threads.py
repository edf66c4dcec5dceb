"""One torch intra-op thread for the port's CPU tests.

The port's renders and plain kernels on the CPU are thousands of small
torch ops. On an 8-core CPU, one 24x24 Cornell render of three waves
takes 0.30 s alone on torch's default pool of eight threads and 0.20 s
on one; in the tier-1 run (six pytest-xdist workers, each with its own
pool of eight) the test that makes five such renders took 118 s: the
pools' threads wait for cores the others hold.
A test module that imports :func:`torch_one_thread` runs its tests on one
thread and restores the pool after them. It changes no input, shape,
seed or tolerance. The CLI tests of ``tests/test_torch_render.py`` run
the port in subprocesses on torch's default pool and hold their PNGs bit
for bit against a one-thread render and a resumed run, so the
multi-threaded CPU path stays tested.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
