"""REP001 fire fixture: a suppression without a reason string."""


def hijack(plan):
    plan._pending = []  # replint-torch: disable=CPL303
