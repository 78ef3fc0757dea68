"""The benchmark of the PyTorch and CUDA port, ``libiqo_tpu_torch``.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of the repository's ``BENCHMARK.json`` on one
card and prints one JSON line.  Everything that belongs to one
configuration, traffic mix, loop or metric is a file of its own, found by
the name that ``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``loops/<loop>.py``, ``metrics/<metric>.py``.
"""
