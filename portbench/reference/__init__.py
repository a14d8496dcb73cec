"""The plain reference that decides ``correct``.

Plain PyTorch: a frozen copy of the port's eager path with the plain
versions of its three kernels, taken when the benchmark was written, so
that later changes to the port cannot move it. It imports nothing of the
port; it works everything out again from the benchmark's input volumes.
``register.detect_describe`` and ``register.register_pairs`` register
pairs.
"""
