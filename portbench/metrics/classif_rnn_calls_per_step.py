"""LSTM calls a classifier step makes: the port's counter
``classif.rnn_calls`` (one a layer's ``nn.LSTM`` call, a recomputed one
again) over the number of its spans ``classif.train_step`` and
``classif.eval_step``, both totals of the traced cycle with the tracer on.
None where the program has no such counter or span."""


def read(r):
    c = r.trace.counts if r.trace is not None else {}
    if not c.get("rnn_steps") or "rnn_calls" not in c:
        return None
    return c["rnn_calls"] / c["rnn_steps"]
