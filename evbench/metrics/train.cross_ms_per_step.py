"""Host ms a step in the cross network's spans, `dlrm.cross` (its forward,
every layer's products and K8) and `dlrm.cross.backward`, over the traced
stretch; None where the program has neither span."""

SPANS = ("dlrm.cross", "dlrm.cross.backward")


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("steps"):
        return None
    spans = tr["spans"]
    if not any(s in spans for s in SPANS):
        return None
    return 1e3 * sum(spans[s]["seconds"] for s in SPANS if s in spans) \
        / tr["steps"]
