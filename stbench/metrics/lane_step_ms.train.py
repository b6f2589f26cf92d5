"""ms a lane step: the loop's wall (steps, validation and bookkeeping) over
the steps of the window's batches, from each batch's `epochs_seconds`; the
traced batch is left out."""


def read(obs):
    rows = obs.get("timings") or []
    steps = sum(r["steps"] for r in rows)
    if not steps:
        return None
    return 1e3 * sum(r["epochs_seconds"] for r in rows) / steps
