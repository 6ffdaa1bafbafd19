"""cover_launches: cover-kernel launches per call
(cutesv_tpu_torch.ops.cover.LAUNCHES, counted from 0 at each call)."""


def read(run):
    n = [c["launches"] for c in run.calls if not c["error"]]
    return sum(n) / len(n) if n else None
