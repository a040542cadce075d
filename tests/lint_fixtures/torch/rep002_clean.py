"""REP002 clean twin: the suppression is actually used."""


def hijack(plan):
    plan._pending = []  # replint-torch: disable=CPL303 -- fixture: suppression is used
