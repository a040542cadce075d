"""CPL303 fire fixture: private state mutated from outside the class."""


def hijack(plan):
    plan._pending = []               # direct assignment
    plan._meters["od"] = 1           # write through a subscript
    plan._queue.append(3)            # mutating method call
