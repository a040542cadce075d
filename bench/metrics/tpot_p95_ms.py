"""95th percentile, over every request sent in the window, of the time per
output token after the first: (done - first token) / (tokens - 1).  A
request unfinished at the drain deadline counts up to the deadline."""
import numpy as np


def read(run):
    v = []
    for r in run.recs:
        first = r.first if r.first is not None else run.deadline
        done = r.done if r.done is not None else run.deadline
        v.append((done - first) / max(r.req.max_new_tokens - 1, 1))
    return float(np.percentile(v, 95)) * 1e3 if v else None
