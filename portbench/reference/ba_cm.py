"""Plain reference of the camera-major BA path: the LM schedule of
sfm.ba.optimize_ba over the steps of reference/ba_pack.py.

Each iteration linearizes once and makes up to 12 tries from it: a step at
lambda (Schur-PCG to |r| <= tol |b| or `cg_maxiter` iterations), retract,
error; the first try whose error is finite and lower is accepted. A reject
multiplies lambda by `factor` and stops the run past `lam_hi`; an accept
stops it when the error fell by at most `abs_tol`, or by at most `rel_tol`
of itself, and divides lambda by `factor` (floor 1e-12).
"""

from portbench.reference import ba_pack as bp


def optimize(state, obs, lam, max_iterations, cg_maxiter, cg_tol=1e-6,
             factor=10.0, lam_hi=1e8, rel_tol=1e-6, abs_tol=1e-6, rnd=None):
    """(state, lam, err, tries)."""
    C, P = state[0].shape[0], state[2].shape[0]
    err = float(bp.error(state, obs, rnd))
    tries = 0
    for _ in range(max_iterations):
        lin = bp.linearize(state, obs, rnd)
        accepted = False
        for _ in range(12):
            dc, dp = bp.step(lin, obs, C, P, lam, cg_maxiter, cg_tol, rnd)
            trial = bp.retract(state, dc, dp)
            e = float(bp.error(trial, obs, rnd))
            tries += 1
            if e == e and e < err:
                accepted = True
                break
            lam *= factor
            if lam > lam_hi:
                return state, lam, err, tries
        if not accepted:
            return state, lam, err, tries
        dec = err - e
        rel = dec / err if err > 0 else 1.0
        state, err = trial, e
        lam = max(lam / factor, 1e-12)
        if dec <= abs_tol or rel <= rel_tol:
            break
    return state, lam, err, tries
