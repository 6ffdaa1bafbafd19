"""Per-SV-type resolvers.

``host``   — exact scalar/numpy engine (behavioral oracle, always available)
``device`` — the DEL/INS engine on cutesv_tpu_torch.ops (PyTorch on CUDA)
"""
