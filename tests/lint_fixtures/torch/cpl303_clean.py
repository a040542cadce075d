"""CPL303 clean twin: classes mutate their own privates; outsiders use the
public API (reads of privates are not mutations)."""


class Plan:
    def __init__(self):
        self._pending = []
        self._count = 0

    def push(self, item):
        self._pending.append(item)
        self._count += 1


def use(plan):
    plan.push(3)
    plan.public_field = 7
    return len(plan._pending)        # read access is fine
