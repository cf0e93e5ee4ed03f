"""Milliseconds per round of ``Sender.make_update`` (serialize, K7/K8, the
row-delta frame): ``RoundReport.update_seconds``, over the window's
rounds."""


def read(run):
    c = run.counters
    if not c.get("rounds"):
        return None
    return 1e3 * c["update_seconds"] / c["rounds"]
