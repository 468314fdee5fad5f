"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the GPU and prints
one JSON line.  Everything a cell needs is found by name: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``), its driver (``drivers/<driver>.py``, named by the
configuration), its plain reference (``reference/<config>.py``), its
correctness limits (``limits/<cell>.json``) and one reader a metric
(``metrics/<metric>.py``).  See ``README.md``.
"""
