"""Host-side IO: BGZF, BAM, FASTA, BED (pure Python; see io/bam.py)."""
from cutesv_tpu_torch.io.bgzf import BgzfReader, BgzfWriter  # noqa: F401
from cutesv_tpu_torch.io.bam import BamReader, BamWriter, BamRecord  # noqa: F401
from cutesv_tpu_torch.io.fasta import FastaFile  # noqa: F401
