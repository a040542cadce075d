"""95th percentile, over every request sent in the window, of the time from
when it was due to the stamp after the step that emitted its first token.
A request with no first token by the drain deadline counts at the
deadline."""
import numpy as np


def read(run):
    if not run.recs:
        return None
    v = [(r.first if r.first is not None else run.deadline) - r.due for r in run.recs]
    return float(np.percentile(v, 95)) * 1e3
