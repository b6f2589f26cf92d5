"""Seconds of a batch's upload, spatial init and model build
(`stage_timings['batch_init_seconds']`), a mean over the window's batches;
the traced batch is left out."""


def read(obs):
    rows = obs.get("timings") or []
    return (sum(r["batch_init_seconds"] for r in rows) / len(rows)
            if rows else None)
