"""Finite-difference Jacobian oracles on manifolds.

JAX counterpart: gtsam_personal_tpu/testing/numerical.py (all of it;
reference: gtsam/base/numericalDerivative.h): central differences through
manifold charts, the check of every autodiff Jacobian. It works on numpy
arrays; `f`, `retract` and `out_local` may wrap torch functions, as long as
they take and give arrays that numpy can read.
"""

import numpy as np


def numerical_jacobian(f, x, retract=None, delta=1e-6, out_local=None,
                       out_dim=None):
    """Central-difference Jacobian of f at the manifold point x.

    f: callable mapping a point (array) to an output array.
    retract: chart at x: (x, tangent_vector) -> point. Defaults to addition.
    out_local: optional chart on the output: (y0, y) -> tangent (for
        manifold-valued outputs). Defaults to subtraction.
    """
    x = np.asarray(x, dtype=np.float64)
    if retract is None:
        retract = lambda p, d: p + d.reshape(p.shape)
        in_dim = x.size
    else:
        in_dim = _tangent_dim_of(retract, x)
    if out_local is None:
        out_local = lambda a, b: (b - a).ravel()
    cols = []
    for i in range(in_dim):
        d = np.zeros(in_dim)
        d[i] = delta
        yp = np.asarray(f(retract(x, d)), dtype=np.float64)
        ym = np.asarray(f(retract(x, -d)), dtype=np.float64)
        cols.append(np.asarray(out_local(ym, yp)) / (2 * delta))
    return np.stack(cols, axis=-1)


def _tangent_dim_of(retract, x):
    # probe: retract must accept a zero vector of its tangent dimension;
    # callers should pass functools.partial with a known dim when ambiguous
    for n in (1, 2, 3, 6, 7, 9, 12):
        try:
            retract(x, np.zeros(n))
            return n
        except Exception:
            continue
    raise ValueError("could not infer tangent dimension; pass out_dim "
                     "explicitly")
