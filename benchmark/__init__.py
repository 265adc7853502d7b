"""The benchmark of multi_car_racing_tpu_torch (batched rollouts on one card).

``run.py`` runs one cell; ``harness/`` holds the window, the trace reader and
the comparison with the plain reference in ``reference/``; ``configs/``,
``traffic/``, ``workloads/``, ``metrics/`` and ``counts/`` hold one file per
configuration, traffic mix, cell, per-layer metric and kernel work counter,
found by name.
"""
