"""The benchmark of ``climate_model_tpu_torch``: cells, readers and the plain
reference that decides ``correct``. ``python3 benchmark/run.py --workload
NAME --seed N --seconds S --trace 0|1`` runs one cell once (README.md)."""
