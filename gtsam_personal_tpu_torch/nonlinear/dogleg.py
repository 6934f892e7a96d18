"""Powell's dogleg and nonlinear conjugate gradient optimizers.

JAX counterpart: gtsam_personal_tpu/nonlinear/dogleg.py (all of it;
reference: DoglegOptimizerImpl, nonlinear/DoglegOptimizerImpl.h:96, the
blend of the steepest-descent and Gauss-Newton points inside the trust
radius Delta with gain-ratio updates; and
NonlinearConjugateGradientOptimizer, a line search over retractions).

The two anchor points come from a sequential elimination
(linear/conditional.py): the Bayes net R x = d with R^T R = H and R^T d =
-g, whose `optimize` is the Gauss-Newton point and whose
`optimize_gradient_search` is the Cauchy point.
"""

import math

import torch

from gtsam_personal_tpu_torch.core.graph import FactorGraph
from gtsam_personal_tpu_torch.core.values import (Layout, Values, tree_axpy,
                                                  tree_norm, tree_scale,
                                                  tree_vdot)
from gtsam_personal_tpu_torch.linear.conditional import eliminate_sequential
from gtsam_personal_tpu_torch.linear.linearize import linearize
from gtsam_personal_tpu_torch.nonlinear.optimizers import (Params, Result,
                                                           check_convergence,
                                                           graph_error)


def _gn_and_gradient(graph: FactorGraph, values: Values):
    """(Gauss-Newton point, Cauchy point, descent direction -g) as tangent
    dicts, by sequential elimination (reference: DoglegOptimizerImpl
    consumes GaussianBayesNet::optimize and ::optimizeGradientSearch)."""
    lin = linearize(graph, values)
    bn = eliminate_sequential(lin, Layout.of(values))
    return (bn.optimize(), bn.optimize_gradient_search(),
            tree_scale(lin.gradient_at_zero(), -1.0))


def _dogleg_point(delta_tr, gn, u):
    """The blend of DoglegOptimizerImpl::Iterate: Cauchy point against
    Gauss-Newton point."""
    u_norm = float(tree_norm(u))
    gn_norm = float(tree_norm(gn))
    if gn_norm <= delta_tr:
        return gn
    if u_norm >= delta_tr:
        return tree_scale(u, delta_tr / max(u_norm, 1e-30))
    # interpolate on the segment u -> gn to the trust-region boundary
    d = {k: gn[k] - u[k] for k in u}
    a = tree_vdot(d, d)
    b = 2.0 * tree_vdot(u, d)
    c = tree_vdot(u, u) - delta_tr ** 2
    tau = ((-b + torch.sqrt(torch.clamp(b * b - 4 * a * c, min=0.0)))
           / torch.clamp(2 * a, min=1e-30))
    return tree_axpy(tau, d, u)


def optimize_dogleg(graph: FactorGraph, values: Values,
                    params: Params = Params(), delta0: float = 1.0) -> Result:
    err = float(graph_error(graph, values))
    delta_tr = delta0
    for it in range(params.max_iterations):
        gn, u, grad = _gn_and_gradient(graph, values)
        accepted = False
        for _ in range(10):
            step = _dogleg_point(delta_tr, gn, u)
            new_values = values.retract(step)
            new_err = float(graph_error(graph, new_values))
            # gain ratio: actual decrease over the first-order decrease g.p
            rho_den = max(float(tree_vdot(grad, step)), 1e-30)
            rho = (err - new_err) / rho_den
            if math.isfinite(new_err) and new_err < err:
                accepted = True
                if rho > 0.75:
                    delta_tr = min(2.0 * delta_tr, 1e5)
                elif rho < 0.25:
                    delta_tr = max(0.5 * delta_tr, 1e-6)
                break
            delta_tr = max(0.5 * delta_tr, 1e-6)
            if delta_tr <= 1e-6:
                return Result(values, err, it, False)
        if not accepted:
            return Result(values, err, it, False)
        values, old_err, err = new_values, err, new_err
        if check_convergence(params, old_err, err):
            return Result(values, err, it + 1, True)
    return Result(values, err, params.max_iterations, False)


def optimize_ncg(graph: FactorGraph, values: Values, params: Params = Params(),
                 ls_shrink: float = 0.5, ls_init: float = 1.0) -> Result:
    """Fletcher-Reeves NCG with a backtracking line search over retractions
    (reference: NonlinearConjugateGradientOptimizer)."""

    def gradient(values):
        return tree_scale(linearize(graph, values).gradient_at_zero(), -1.0)

    err = float(graph_error(graph, values))
    g = gradient(values)
    d = g
    g2 = float(tree_vdot(g, g))
    for it in range(params.max_iterations):
        # backtracking line search along d
        alpha = ls_init
        improved = False
        for _ in range(25):
            cand = values.retract(tree_scale(d, alpha))
            cand_err = float(graph_error(graph, cand))
            if math.isfinite(cand_err) and cand_err < err:
                improved = True
                break
            alpha *= ls_shrink
        if not improved:
            return Result(values, err, it, it > 0)
        values, old_err, err = cand, err, cand_err
        g_new = gradient(values)
        g2_new = float(tree_vdot(g_new, g_new))
        beta = g2_new / max(g2, 1e-30)
        d = tree_axpy(beta, d, g_new)
        g, g2 = g_new, g2_new
        if check_convergence(params, old_err, err):
            return Result(values, err, it + 1, True)
    return Result(values, err, params.max_iterations, False)
