"""Front end: median time from a request's due time to the start of the
first step in which it held a slot (``ServingEngine.active``)."""
import numpy as np


def read(run):
    if not run.recs:
        return None
    v = [(r.admit if r.admit is not None else run.deadline) - r.due for r in run.recs]
    return float(np.median(v)) * 1e3
