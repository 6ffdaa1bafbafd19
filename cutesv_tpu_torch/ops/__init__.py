"""Device programs (PyTorch; hand-written CUDA where a TPU kernel stood).

    segments.py       boundary flags and segment reductions on tensors
    indel_cluster.py  the DEL/INS cluster-structure program + compaction
    pair_cluster.py   the DUP/INV/TRA pair-cluster program + compaction
    sweep.py          the cover-count coordinate contract and its plain
                      PyTorch version
    cover.py          the cover-count CUDA kernel's wrapper (csrc/cover_count.cu)
    inflate.py        the BGZF inflate CUDA kernel's wrapper, its plain zlib
                      version and the decoder's card back end
                      (csrc/bgzf_inflate.cu)
    build.py          nvcc build + ctypes load of the csrc/ kernels
"""
