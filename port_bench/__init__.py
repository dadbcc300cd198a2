"""The benchmark of the PyTorch port (``parfastaai_tpu_torch``): CLI calls
from SQLite to CSV, driven in a closed loop and judged against a plain
reference.  Run a cell with ``python3 port_bench/run.py``."""
