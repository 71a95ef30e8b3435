"""The benchmark of the PyTorch and CUDA port (``nkbx_torch``) on one NVIDIA
H100. See ``run.py`` for the command and ``spec.py`` for how a cell's
files are found."""
