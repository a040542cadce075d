"""REP001 clean twin: the suppression carries its reason."""


def hijack(plan):
    plan._pending = []  # replint-torch: disable=CPL303 -- fixture: reasoned suppression
