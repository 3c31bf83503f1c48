"""The benchmark of facenet_tpu_torch, the PyTorch and CUDA port: one cell
(a configuration under a traffic mix) a run of ``run.py``."""
