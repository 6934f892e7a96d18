"""Mean PCG iterations a try of sfm.ba.optimize_ba, the `iterations` that
its probe's "pcg" call carries, over one request's tries."""


def read(rec):
    its = rec.get("spans", {}).get("ba_pcg_iters")
    return sum(its) / len(its) if its else None
