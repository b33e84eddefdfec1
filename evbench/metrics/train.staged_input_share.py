"""The share of the train step's input copies that came through its
staging ring, in %, over the traced stretch: 100 x the count of
`train_step.inputs.stage` spans (each host write into a pinned staging
buffer) over the count of `train_step.inputs.copy` spans (one an input a
step); 0.0 where the program copies without staging, None where it has
no copy span."""

STAGE, COPY = "train_step.inputs.stage", "train_step.inputs.copy"


def read(record):
    tr = record.get("trace")
    if not tr or COPY not in tr.get("spans", {}):
        return None
    copies = tr["spans"][COPY]["count"]
    if not copies:
        return None
    return 100.0 * tr["spans"].get(STAGE, {"count": 0})["count"] / copies
