"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``,
the limits of its output check in ``limits/<cell>.json`` and each metric's
reader in ``metrics/<metric>.py``.  The corpus generator, the query
generators, the plain reference and the roofline arithmetic are this
folder's own frozen copies: nothing here imports the JAX package.
"""
