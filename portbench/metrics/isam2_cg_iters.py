"""Mean CG iterations an update over the window's updates
(ISAM2Result.cg_iterations)."""


def read(rec):
    its = rec["counters"].get("cg_iterations")
    return sum(its) / len(its) if its else None
