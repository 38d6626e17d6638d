"""Pytest root configuration: a CPU thread budget per test worker.

Under pytest-xdist each worker runs its tests in its own process, and torch
would give each of them one intra-op thread per core: the workers' threads
together would outnumber the cores many times over and spin against each
other.  Each worker takes its share of the cores instead.  A run without
xdist keeps torch's default.

``tests/conftest.py`` configures JAX for the tests themselves.
"""

import os

workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if workers:
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
