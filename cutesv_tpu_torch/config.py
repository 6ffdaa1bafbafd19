"""Run configuration for the SV-calling engine.

Mirrors the CLI surface of the reference caller (cuteSV_Description.py:53-263)
as a typed dataclass, and adds a real ``--preset`` flag expanding to the
platform-specific values the reference only documents
(cuteSV_Description.py:30-46, README.md:67-85).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # ---- inputs / outputs -------------------------------------------------
    input: str = ""            # sorted BAM
    reference: str = ""        # FASTA
    output: str = ""           # VCF path
    work_dir: str = ""         # scratch dir for signature checkpoints

    # ---- runtime ----------------------------------------------------------
    threads: int = 16          # host-side decode / emit parallelism
    batches: int = 10_000_000  # cuteSV-compat flag; no-op (single streaming
    #                            decode pass replaces interval batching)
    sample: str = "NULL"
    retain_work_dir: bool = False
    write_old_sigs: bool = False
    report_readid: bool = False
    ignore_sequence: bool = False

    # ---- signature collection (cuteSV_Description.py:109-135) -------------
    max_split_parts: int = 7
    min_mapq: int = 20
    min_read_len: int = 500
    merge_del_threshold: int = 0
    merge_ins_threshold: int = 100
    include_bed: Optional[str] = None

    # ---- clustering (cuteSV_Description.py:139-155) -----------------------
    min_support: int = 10
    min_size: int = 30
    max_size: int = 100_000
    min_siglength: int = 10

    # ---- genotyping (cuteSV_Description.py:158-177) -----------------------
    genotype: bool = False
    gt_round: int = 500
    read_range: int = 1000

    # ---- force calling (disabled in reference CLI, cuteSV:999-1000) -------
    Ivcf: Optional[str] = None

    # ---- advanced, per-type (cuteSV_Description.py:194-249) ---------------
    max_cluster_bias_INS: int = 100
    diff_ratio_merging_INS: float = 0.3
    max_cluster_bias_DEL: int = 200
    diff_ratio_merging_DEL: float = 0.5
    max_cluster_bias_INV: int = 500
    max_cluster_bias_DUP: int = 500
    max_cluster_bias_TRA: int = 50
    diff_ratio_filtering_TRA: float = 0.6
    remain_reads_ratio: float = 1.0

    # ---- engine knobs (new; no reference equivalent) ----------------------
    engine: str = "auto"       # "device" (GPU), "host" (numpy oracle), "auto"
    decoder: str = "auto"      # "native" (C++), "python", "auto"
    n_shards: int = 1          # device-mesh width for the genome axis
    resume: bool = False       # resume from work_dir/sigstore.pickle
    profile: bool = False      # profile the resolve stage (not ported yet)
    distributed: bool = False  # multi-host run (not ported yet)
    coordinator: str = None    # coordinator address host:port (or auto)
    num_processes: int = None  # processes in the pod-slice run (or auto)
    process_id: int = None     # this process's index (or auto)


# Platform presets, from the reference's documented suggestions
# (cuteSV_Description.py:30-46). Keys are lowercase.
PRESETS = {
    "clr": dict(
        max_cluster_bias_INS=100, diff_ratio_merging_INS=0.3,
        max_cluster_bias_DEL=200, diff_ratio_merging_DEL=0.5,
    ),
    "ccs": dict(
        max_cluster_bias_INS=1000, diff_ratio_merging_INS=0.9,
        max_cluster_bias_DEL=1000, diff_ratio_merging_DEL=0.5,
    ),
    "hifi": dict(  # alias of ccs
        max_cluster_bias_INS=1000, diff_ratio_merging_INS=0.9,
        max_cluster_bias_DEL=1000, diff_ratio_merging_DEL=0.5,
    ),
    "ont": dict(
        max_cluster_bias_INS=100, diff_ratio_merging_INS=0.3,
        max_cluster_bias_DEL=100, diff_ratio_merging_DEL=0.3,
    ),
}


def apply_preset(cfg: Config, preset: str, skip=()) -> Config:
    """Expand a platform preset into its per-type clustering values.

    ``skip``: field names the user set explicitly on the command line —
    those keep their explicit values instead of being overridden by the
    preset.
    """
    values = PRESETS.get(preset.lower())
    if values is None:
        raise ValueError(
            "unknown preset %r (choose from %s)" % (preset, sorted(PRESETS)))
    values = {k: v for k, v in values.items() if k not in skip}
    return dataclasses.replace(cfg, **values)
