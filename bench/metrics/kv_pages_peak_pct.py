"""KV pool: the most pages held at a step boundary in the window, as a share
of the pool's pages (the trash page left out)."""


def read(run):
    steps = run.window_steps
    if not steps or not run.kv_pages:
        return None
    return 100.0 * max(s.pages_used for s in steps) / run.kv_pages
