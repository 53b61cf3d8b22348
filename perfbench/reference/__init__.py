"""The benchmark's plain reference: ``plain/`` holds a frozen copy of the
port's plain datagen and model paths (the versions that a CPU tensor takes),
with every CUDA kernel wrapper and the dispatch to it removed, so each path
runs its plain PyTorch version on any device. Their docstrings are the
port's as copied. ``training.py`` is the training step written out;
``precision.py`` the lower precisions of the controls. Nothing here imports
the port, and later changes to the port leave it as it is."""
