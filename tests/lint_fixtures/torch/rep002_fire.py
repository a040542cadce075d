"""REP002 fire fixture: a suppression that matches no finding."""


def fine():
    return 1  # replint-torch: disable=TRC101 -- nothing here actually syncs
