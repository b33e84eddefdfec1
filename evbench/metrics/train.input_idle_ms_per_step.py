"""The device's idle ms a step while the host was inside `train_step.inputs`
or a span under it (`train_step.inputs.check`, `.copy`), over the traced
stretch: the `idle_gaps` that `tracing.reduce_trace` puts in that family,
over the steps.  `idle_gaps` keeps the ten names with the most idle, so a
member of the family below the tenth is left out.  0.0 where the program
has the span and no gap fell in it; None where it has no such span."""

FAMILY = "train_step.inputs"


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("steps") or FAMILY not in tr["spans"]:
        return None
    return 1e3 * sum(s for name, s in tr["idle_gaps"]
                     if name == FAMILY or name.startswith(FAMILY + ".")) \
        / tr["steps"]
