"""One setting for the whole test run: torch's CPU ops run on one thread.

Under pytest-xdist every worker imports every test module while it
collects, so this module's first statement takes effect in every worker
before any test runs. With torch's default (an intra-op thread a core)
each port test fans its larger ops out over every core beside the other
workers, whose processes hold as many threads again: the cores are
oversubscribed, a parallel region waits on descheduled threads, and the
JAX package's long files, which set the run's wall time, slow down. The
port's tests hold integer results bit for bit and float results within
stated tolerances, neither of which depends on the thread count."""

import torch

torch.set_num_threads(1)


def test_torch_runs_one_thread_a_worker():
    assert torch.get_num_threads() == 1
