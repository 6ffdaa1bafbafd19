"""cutesv-tpu-torch: the PyTorch/CUDA port of the cutesv-tpu SV caller.

A second package beside ``cutesv_tpu`` that runs the same discovery
pipeline with PyTorch on an NVIDIA GPU (Hopper, ``sm_90a``). Host layers
(BAM/FASTA IO, signature extraction, the signature store, genotype
likelihoods, the numpy oracle resolvers, VCF emission) are this
package's own copies; the device work is PyTorch compositions plus the
hand-written CUDA kernels under ``csrc/``.

Package layout:
    io/        BGZF + BAM + FASTA readers (and a BAM writer for fixtures)
    ops/       device programs (segments, DEL/INS cluster structure, the
               cover-count kernel wrapper and its plain version)
    csrc/      CUDA C++ kernel sources, built with nvcc at first use
    models/    per-SV-type resolvers (host oracle; DEL/INS device engine)
    utils/     device selection
    tools/     corpus simulator
"""

__version__ = "0.1.0"

REFERENCE_VERSION = "2.1.4"  # cuteSV version whose behavior we reproduce
