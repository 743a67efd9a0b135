"""The benchmark of aaltoasr_tpu_torch: run one cell with `python3 portbench/run.py`."""
