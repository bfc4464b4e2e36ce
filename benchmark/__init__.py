"""The benchmark of ``priordepth_gaussiansplatting_torch`` on NVIDIA cards.
Run a cell with ``python3 -m benchmark.run`` (see ``run.py``)."""
