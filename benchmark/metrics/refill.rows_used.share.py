"""The share of the rows the refill pregenerates that it writes into an
empty queue slot: the program's counter ``refill.rows_used`` over
``refill.rows`` (a bucket's rows per pass) in the traced window; None where
the program has no telemetry or no refill ran."""


def read(run):
    try:
        from procgen_torch import telemetry
    except ImportError:
        return None
    counters = telemetry.snapshot()["counters"]
    rows = counters.get("refill.rows", 0)
    return counters.get("refill.rows_used", 0) / rows if rows else None
