"""The benchmark of the PyTorch/CUDA SV caller ``cutesv_tpu_torch``
(see README.md)."""
