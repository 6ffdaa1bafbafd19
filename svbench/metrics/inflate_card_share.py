"""inflate_card_share: the share of the BAM's BGZF blocks that the card
inflated, blocks_card / (blocks_card + blocks_host), the mean per call:
the ``blocks_card`` and ``blocks_host`` counters of the program's
``decode.walk`` span (stats["trace"]; the header's blocks count too).
Nothing to read without those counters."""


def read(run):
    per_call = []
    for c in run.calls:
        if c["error"] or "trace" not in c["stats"]:
            continue
        walks = [s["counters"] for s in c["stats"]["trace"]["spans"]
                 if s["name"] == "decode.walk"
                 and "blocks_card" in s["counters"]]
        card = sum(w["blocks_card"] for w in walks)
        host = sum(w["blocks_host"] for w in walks)
        if card + host > 0:
            per_call.append(card / (card + host))
    return sum(per_call) / len(per_call) if per_call else None
