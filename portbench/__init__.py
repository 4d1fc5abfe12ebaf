"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one command
runs one cell (a model configuration under a traffic mix) on the card and
prints one JSON result line.  See ``run.py``."""
