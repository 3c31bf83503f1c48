"""Measurement scripts of the port, run as ``python -m
facenet_tpu_torch.tools.<name>``. They time on a CUDA device and raise
without one; ``--device cpu`` runs their equivalence halves on the kernels'
plain versions."""
