"""cluster_graph_share: the share of the DEL/INS cluster programs that
ran as the replay of a captured CUDA graph, the mean per call of the
``cluster.dispatch`` spans with ``graph`` = 1 over all of them
(stats["trace"]). Nothing to read without the span."""


def read(run):
    per_call = []
    for c in run.calls:
        if c["error"] or "trace" not in c["stats"]:
            continue
        graph = [s["counters"].get("graph", 0)
                 for s in c["stats"]["trace"]["spans"]
                 if s["name"] == "cluster.dispatch"]
        if graph:
            per_call.append(sum(1 for g in graph if g == 1) / len(graph))
    return sum(per_call) / len(per_call) if per_call else None
