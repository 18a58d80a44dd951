"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA H100 cards.

``run.py`` runs one cell once (``BENCHMARK.json`` at the repository root names
the cells). A cell's configuration, traffic mix, metrics and limits are files
of their own, found by name (:mod:`h100bench.spec`). ``sweep.py`` and
``control.py`` are the tools that fixed the open-loop rates and the limits of
``correct``; ``tests/`` are the harness's CPU tests
(``python -m pytest h100bench/tests``). Nothing here imports JAX or the JAX
package.
"""
