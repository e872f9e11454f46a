"""The port's benchmark: one cell of ``BENCHMARK.json`` a run
(``python3 perfbench/run.py``)."""
