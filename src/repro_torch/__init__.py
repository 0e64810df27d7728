"""The line detector in PyTorch for one NVIDIA H100.

A port of the ``repro`` package (JAX on a TPU), module for module: the
staged detector ``Canny -> compacted Hough vote -> get_lines`` runs on the
card through two hand-written CUDA kernels (``kernels/csrc``), with the
plain PyTorch version of each kernel kept beside it for the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:

    from repro_torch.core import LineDetector, PipelineConfig
    det = LineDetector(PipelineConfig(), device="cpu")

Importing the package needs neither ``nvcc`` nor a GPU: the kernels are
compiled at first launch (``kernels/_build.py``).
"""
