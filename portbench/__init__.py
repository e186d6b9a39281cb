"""The benchmark of the PyTorch port: ``python3 -m portbench --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once on the cards of this machine and prints one JSON
line (see ``harness.py``)."""
