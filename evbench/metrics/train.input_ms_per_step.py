"""Host ms a step inside the train step's span `train_step.inputs` (the
host id check and the host-to-device copies of the batch), over the traced
stretch; None where the program has no such span."""

SPAN = "train_step.inputs"


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("steps") or SPAN not in tr["spans"]:
        return None
    return 1e3 * tr["spans"][SPAN]["seconds"] / tr["steps"]
