"""setup_s: from the process's start to the window's start (imports,
CUDA context, kernel load or build, the corpus, the warm-up call)."""


def read(run):
    return run.setup_s
