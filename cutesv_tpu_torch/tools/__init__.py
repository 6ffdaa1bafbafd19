"""Standalone tools: the simulator, post-processing, evaluation and
benchmarks.

Counterparts of ``cutesv_tpu/tools/`` and of the repo's root ``tools/``:
    simulate           synthetic long-read SV corpora (simulate, --messy,
                       replay of VISOR truth beds)
    vcfio              shared text-VCF reader (replaces pyvcf3)
    diploid_calling    haplotype-tag GT rewrite for assembly alignments
    vcf2bedpe          VCF -> BEDPE conversion
    eval_sim           simulation truth-set evaluation (TP/FN, genotype-aware)
    compare            callset comparison CLIs (eval_bnd, eval_trio,
                       concordance, cmp_base, cmp_na19240)
    eval_forcecalling  force-calling / population tables (POP, COMP, CMRG)
    replay_eval        whole-genome replay evaluation driver (--device)
    baseline_pool      pool-parallel host-oracle baseline (forked workers)
    bench_kernels      the device programs and the cover kernel on the card
                       against same-card rooflines
    bench_tra          BND-storm benchmark
    scale_run          genome-scale run in a fresh process
"""
