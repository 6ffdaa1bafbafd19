"""cutesv-tpu-torch: the PyTorch/CUDA port of the cutesv-tpu SV caller.

A second package beside ``cutesv_tpu`` that runs the same discovery
pipeline with PyTorch on an NVIDIA GPU (Hopper, ``sm_90a``). Host layers
(BAM/FASTA IO, signature extraction, the signature store, genotype
likelihoods, the numpy oracle resolvers, VCF emission) are this
package's own copies; the device work is PyTorch compositions plus the
hand-written CUDA kernels under ``csrc/``.

Package layout:
    cli.py, pipeline.py, forcecalling.py
               the CLI, the discovery pipeline and force calling (-Ivcf)
    entry.py   the flagship path's entry() and the multi-device dry run
    io/        BGZF + BAM + CRAM + FASTA readers (and BAM/CRAM writers for
               fixtures), the native decoder's loader
    native/    the C++ BAM/CRAM decoder, built with g++ at first use
    ops/       device programs (segments, the DEL/INS and DUP/INV/TRA
               cluster programs, the cover-count kernel wrapper and its
               plain version)
    csrc/      CUDA C++ kernel sources, built with nvcc at first use
    models/    per-SV-type resolvers (host oracle; device engine for DEL,
               INS, DUP, INV and TRA)
    parallel/  multi-process runs (--distributed) over torch.distributed;
               --n_shards over a device list (mesh.py, sharded_cover.py)
    utils/     device selection, the shell/cluster command runner
    tools/     simulator, evaluation and comparison CLIs, replay driver,
               pooled baseline, benchmarks
"""

__version__ = "0.1.0"

REFERENCE_VERSION = "2.1.4"  # cuteSV version whose behavior we reproduce
