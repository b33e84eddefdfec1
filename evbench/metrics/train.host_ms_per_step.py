"""Host ms a step in the train step's four spans (`train_step.gather`,
`.forward_backward`, `.dense_update`, `.row_update`), over the traced
stretch."""

PARTS = ("train_step.gather", "train_step.forward_backward",
         "train_step.dense_update", "train_step.row_update")


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("steps"):
        return None
    spans = tr["spans"]
    if not any(p in spans for p in PARTS):
        return None
    return 1e3 * sum(spans[p]["seconds"] for p in PARTS if p in spans) \
        / tr["steps"]
