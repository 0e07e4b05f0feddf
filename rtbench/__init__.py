"""rtbench: the benchmark of the PyTorch/CUDA port ``ray_tracer_2_tpu_torch``.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by the names ``BENCHMARK.json``
gives: a configuration's data file and builder (``configs/<config>.json``,
``configs/<config>.py``), a traffic mix's data file (``traffic/<traffic>.json``,
read by ``traffic.py``), a cell's limits and frozen work
(``cells/<cell>.json``), and each metric's reader, end-to-end and
per-layer alike (``metrics/<metric>.py``). The plain reference that
decides ``correct`` lives in ``reference/`` and imports nothing of the
program.
"""
