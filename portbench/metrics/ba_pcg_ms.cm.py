"""Mean ms of PCG a try of sfm.ba.optimize_ba: CUDA events at the engine's
probe labels "precond" and "pcg", over one request's tries."""


def read(rec):
    ms = rec.get("spans", {}).get("ba_pcg_ms")
    return sum(ms) / len(ms) if ms else None
