"""Give this test process its share of the CPU's threads.

pytest-xdist runs ``PYTEST_XDIST_WORKER_COUNT`` workers side by side, and
left alone each one takes torch's default intra-op pool of one OpenMP
thread a CPU: six workers on eight CPUs then run 48 spinning threads, and
a test that takes 6 s alone takes minutes. So each process gets
``THREADS``, the CPUs it may run on divided by the workers that share
them (at least one). A file run alone gets every CPU.

``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS`` are set to the same count
unless they are set already, so the Python processes a test starts (the
CLI, the tools, multihost ranks) inherit it.

Every ``tests/test_torch_*.py`` imports this module before torch and the
port (``import cpu_share  # noqa: F401``). With one thread ATen's parallel
loops run inline, so what depends on the thread count is held by a test
that renders in a child process with the full pool
(``test_torch_threads.py``).
"""

import os

THREADS = max(1, len(os.sched_getaffinity(0))
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

for _name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_name, str(THREADS))

import torch  # noqa: E402

torch.set_num_threads(THREADS)
