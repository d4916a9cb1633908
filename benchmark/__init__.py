"""The benchmark of ``myraytracer_tpu_torch`` on CUDA cards.

``run.py`` runs one cell (a configuration under a traffic mix, as
``BENCHMARK.json`` names them) and prints its result line; ``control.py``
takes the readings the correctness limits are set from; ``tests/`` holds
the CPU tests (``python -m pytest benchmark/tests``). Configurations,
traffic mixes, limits and metric readers are files found by name; a
configuration may name its own world module and reference package
(``registry.py``).
"""
