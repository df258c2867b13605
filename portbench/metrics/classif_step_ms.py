"""Milliseconds a classifier train step takes in the window: the harness's
span around each ``ClassifierTrainer.train_epoch`` (which ends in the read of
the steps' losses, so the span ends with the epoch's device work), summed
and divided by the window's train steps."""


def read(r):
    if not r.counts.get("classif_train_steps"):
        return None
    return 1e3 * sum(r.spans["train_epoch"]) / r.counts["classif_train_steps"]
