"""The benchmark of ``fluidsim_tpu_torch``, the PyTorch and CUDA port.

``portbench/run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything a
cell, a configuration or a metric needs is found by name: a configuration in
``configs/<name>.json``, a cell in ``cells/<name>.json``, a metric's reader
in ``metrics/<name>.py``, the program-side driver a cell names in
``drivers/<name>.py`` and the plain reference a configuration names in
``reference/<name>.py``.  Nothing here imports JAX or the JAX package, and
the reference imports nothing of the port.
"""
