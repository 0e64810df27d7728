"""The port's kernels: hand CUDA kernels for the card (``csrc/``), their
plain PyTorch versions (``ref.py``), and the device dispatch (``ops.py``)."""
