"""Device programs (PyTorch; hand-written CUDA where a TPU kernel stood).

    segments.py       boundary flags and segment reductions on tensors
    indel_cluster.py  the DEL/INS cluster-structure program + compaction
    sweep.py          the cover-count coordinate contract and its plain
                      PyTorch version
    cover.py          the cover-count CUDA kernel's wrapper (csrc/cover_count.cu)
    build.py          nvcc build + ctypes load of the csrc/ kernels
"""
