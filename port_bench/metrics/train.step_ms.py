"""Milliseconds per microbatch of the round's steps (the row-sparse step,
the masked backward on K10, AdaGrad): each round's ``RoundReport.seconds``
less its ``update_seconds``, summed over the window's rounds, over their
microbatches."""


def read(run):
    c = run.counters
    if not c.get("microbatches"):
        return None
    return 1e3 * c["step_seconds"] / c["microbatches"]
