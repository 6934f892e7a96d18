"""Nonlinear least-squares optimizers: Gauss-Newton and Levenberg-Marquardt.

JAX counterpart: gtsam_personal_tpu/nonlinear/optimizers.py:Params,
check_convergence, graph_error, optimize_gn, optimize_lm, lm_run,
optimize_lm_jit, Result (lines 34-329). Semantics follow the reference's optimizers:
- the convergence test is NonlinearOptimizer::checkConvergence
  (nonlinear/NonlinearOptimizer.cpp:182);
- the LM lambda schedule is LevenbergMarquardtOptimizer with
  useFixedLambdaFactor (LevenbergMarquardtOptimizer.cpp:121-273): try a solve
  at lambda; accept (lambda /= factor) if the error decreased, else reject
  (lambda *= factor);
- optional diagonal damping lambda * diag(H) as in `buildDampedSystem`.

Solvers: "dense" (the assembled normal equations), "pcg" (block-Jacobi
CG), "schur" with a two-level `schur.SchurPlan` or a multi-level
`mlschur.MLPlan`, "qr" (dense QR of the whitened Jacobian, identity
damping only) and "sequential" (sequential elimination into a
GaussianBayesNet and its back-substitution). `fm=True` is accepted and runs
the row layout: the JAX package's feature-major layout (linear/fm.py, which
it takes for "pcg" and "schur") is a relayout for the TPU's tiles that
exact-matches its row layout, so the row layout computes the same
function. `optimize_lm_jit` keeps the JAX single program's rules (its own,
not `optimize_lm`'s) with the loop on the host.

On a failure (a non-finite error, or lambda past its bound) `optimize_gn`
and `optimize_lm` print linear/diagnostics.py's report when
`diagnose_on_failure` is set (reference: IndeterminantLinearSystemException
naming the key, linear/linearExceptions.h).
"""

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from gtsam_personal_tpu_torch.core.graph import FactorGraph
from gtsam_personal_tpu_torch.core.values import Layout, Values, tree_norm
from gtsam_personal_tpu_torch.linear import conditional, diagnostics, solvers
from gtsam_personal_tpu_torch.linear.linearize import linearize
from gtsam_personal_tpu_torch.linear.mlschur import MLPlan, solve_ml
from gtsam_personal_tpu_torch.linear.schur import SchurPlan, solve_partitioned

SOLVERS = ("dense", "pcg", "schur", "qr", "sequential")


@dataclass(frozen=True)
class Params:
    """Reference analogue: NonlinearOptimizerParams +
    LevenbergMarquardtParams."""
    max_iterations: int = 100
    relative_error_tol: float = 1e-5
    absolute_error_tol: float = 1e-5
    error_tol: float = 0.0
    solver: str = "dense"          # one of SOLVERS
    pcg_maxiter: int = 250
    pcg_tol: float = 1e-8
    fm: bool = False               # feature-major layout: the row layout here
    # LM:
    lambda_initial: float = 1e-5
    lambda_factor: float = 10.0
    lambda_upper_bound: float = 1e5
    lambda_lower_bound: float = 0.0
    diagonal_damping: bool = False
    max_inner_tries: int = 10
    verbose: bool = False
    # on a failure, print linear/diagnostics.py's report: the non-finite
    # factor rows and the singular variables
    diagnose_on_failure: bool = True
    # reference: NonlinearOptimizerParams::iterationHook(iter, errBefore,
    # errAfter), called after every accepted iteration
    # (NonlinearOptimizer.cpp:99)
    iteration_hook: Optional[Callable] = None


def check_convergence(params: Params, old_err, new_err):
    """Reference: checkConvergence (NonlinearOptimizer.cpp:182)."""
    if new_err <= params.error_tol:
        return True
    abs_dec = old_err - new_err
    rel_dec = abs_dec / old_err if old_err > 0 else 1.0
    return (abs_dec <= params.absolute_error_tol
            or rel_dec <= params.relative_error_tol)


def _check_supported(params: Params, plan):
    if params.solver not in SOLVERS:
        raise ValueError(f"unknown solver {params.solver!r}")
    if params.solver == "schur" and not isinstance(plan, (SchurPlan,
                                                          MLPlan)):
        if plan is None:
            raise ValueError("solver 'schur' needs plan=schur.make_plan(...) "
                             "or mlschur.make_ml_plan(...)")
        raise TypeError(f"solver 'schur' takes a schur.SchurPlan or an "
                        f"mlschur.MLPlan, not a {type(plan).__name__}")


def _solve(lin, layout, lam, diag_damping, params: Params, plan):
    if params.solver == "pcg":
        return solvers.solve_pcg(lin, lam, diag_damping,
                                 maxiter=params.pcg_maxiter,
                                 tol=params.pcg_tol)
    if params.solver == "schur":
        if isinstance(plan, MLPlan):
            return solve_ml(lin, plan, lam)
        return solve_partitioned(lin, plan, lam)
    if params.solver == "qr":
        # never forms J^T J (reference: EliminateQR); identity damping only
        return conditional.solve_qr(lin, layout, lam)
    if params.solver == "sequential":
        # reference: eliminateSequential + GaussianBayesNet::optimize
        return conditional.eliminate_sequential(lin, layout,
                                                lam=lam).optimize()
    return solvers.solve_dense(
        lin, layout, lam,
        layout.flatten(diag_damping) if diag_damping is not None else None)


def _linearize(graph, values, params: Params):
    lin = linearize(graph, values)
    return lin, lin.hessian_diagonal() if params.diagonal_damping else None


def _lm_try_step(graph: FactorGraph, values: Values, lam, params: Params,
                 plan=None):
    """One linearize + damped solve + retract + error evaluation."""
    lin, dd = _linearize(graph, values, params)
    delta = _solve(lin, Layout.of(values), lam, dd, params, plan)
    new_values = values.retract(delta)
    return new_values, graph.error(new_values), tree_norm(delta)


def graph_error(graph: FactorGraph, values: Values):
    return graph.error(values)


def _maybe_diagnose(graph, values, params: Params):
    """On a failure, print the non-finite factor rows and the singular
    variables (reference: IndeterminantLinearSystemException)."""
    if not params.diagnose_on_failure:
        return
    try:
        rep = diagnostics.diagnose(graph, values)
        if not rep.ok:
            print(rep)
    except Exception as e:  # the diagnosis must never mask the failure
        print(f"(diagnosis failed: {e})")


@dataclass
class Result:
    values: Values
    error: float
    iterations: int
    converged: bool
    lambda_final: float = 0.0


def optimize_gn(graph: FactorGraph, values: Values, params: Params = Params(),
                plan=None) -> Result:
    """Gauss-Newton: linearize -> solve -> retract until converged
    (reference: GaussNewtonOptimizer)."""
    _check_supported(params, plan)
    err = float(graph_error(graph, values))
    for it in range(params.max_iterations):
        new_values, new_err, _ = _lm_try_step(graph, values, 0.0, params,
                                              plan)
        new_err = float(new_err)
        if params.verbose:
            print(f"GN iter {it}: error {err:.6g} -> {new_err:.6g}")
        if not math.isfinite(new_err):
            _maybe_diagnose(graph, values, params)
            return Result(values, err, it, False)
        converged = check_convergence(params, err, new_err)
        if new_err <= err:
            values, err = new_values, new_err
        if converged:
            return Result(values, err, it + 1, True)
        if new_err > err:  # diverging and not converged
            return Result(values, err, it, False)
    return Result(values, err, params.max_iterations, False)


def optimize_lm(graph: FactorGraph, values: Values, params: Params = Params(),
                plan=None) -> Result:
    """Levenberg-Marquardt with the reference's fixed-factor lambda
    schedule, driven from the host (one error read per try)."""
    _check_supported(params, plan)
    err = float(graph_error(graph, values))
    lam = params.lambda_initial
    for it in range(params.max_iterations):
        accepted = False
        for _ in range(params.max_inner_tries):
            new_values, new_err, _ = _lm_try_step(graph, values, lam, params,
                                                  plan)
            new_err = float(new_err)
            if math.isfinite(new_err) and new_err < err:
                accepted = True
                break
            lam = lam * params.lambda_factor
            if lam > params.lambda_upper_bound:
                _maybe_diagnose(graph, values, params)
                return Result(values, err, it, False, lam)
        if not accepted:
            _maybe_diagnose(graph, values, params)
            return Result(values, err, it, False, lam)
        if params.verbose:
            print(f"LM iter {it}: error {err:.6g} -> {new_err:.6g} "
                  f"(lambda {lam:.2g})")
        values, old_err, err = new_values, err, new_err
        if params.iteration_hook is not None:
            params.iteration_hook(it, old_err, err)
        lam = max(lam / params.lambda_factor, params.lambda_lower_bound,
                  1e-10)
        if check_convergence(params, old_err, err):
            return Result(values, err, it + 1, True, lam)
    return Result(values, err, params.max_iterations, False, lam)


def lm_run(graph: FactorGraph, values: Values, lam, err, n_iters: int,
           params: Params = Params(), plan=None):
    """`n_iters` full LM iterations; returns (values, lam, err) with lam and
    err as 0-dim tensors on the device. Every iteration is an accept/reject
    tryLambda step with the fixed-factor lambda adaptation
    (LevenbergMarquardtOptimizer.cpp:121), and a REJECTED try reuses the
    cached linearization: the state did not move, so linearizing again
    would compute the same numbers.

    The JAX package runs this as one `lax.scan` over `lax.cond`. Here the
    values, lambda and the error stay on the device, and the loop reads ONE
    flag per iteration from it, the accept decision, to skip the
    linearization after a reject. Linearizing always and reading nothing
    would give the same result; the flag is read because the eager
    linearization is the most expensive phase on the host."""
    _check_supported(params, plan)
    layout = Layout.of(values)
    first = next(iter(values.blocks.values()))
    lam = torch.as_tensor(lam, dtype=first.dtype, device=first.device)
    err = torch.as_tensor(err, dtype=first.dtype, device=first.device)
    lam_min = max(params.lambda_lower_bound, 1e-10)

    need = True
    for _ in range(n_iters):
        if need:
            lin, dd = _linearize(graph, values, params)
        delta = _solve(lin, layout, lam, dd, params, plan)
        new_values = values.retract(delta)
        new_err = graph.error(new_values)
        need = bool(torch.isfinite(new_err) & (new_err < err))
        if need:
            values, err = new_values, new_err
            lam = torch.clamp(lam / params.lambda_factor, min=lam_min)
        else:
            lam = torch.clamp(lam * params.lambda_factor,
                              max=params.lambda_upper_bound)
    return values, lam, err


def optimize_lm_jit(graph: FactorGraph, values: Values,
                    params: Params = Params(),
                    max_iterations: Optional[int] = None, plan=None):
    """LM with the rules of the JAX package's one-program LM (a
    `lax.while_loop` over iterations, a `lax.scan` of tries in each), which
    differ from `optimize_lm`'s: an iteration makes up to
    `max_inner_tries` tries from lambda (times `lambda_factor` after each
    reject) and keeps the first accepted one; there is no
    `lambda_upper_bound` exit; after the iteration lambda is divided by the
    factor with a floor of 1e-10 (not `lambda_lower_bound`); it is
    converged when the new error is <= `error_tol` or the absolute or
    relative decrease is below its tolerance (relative 0 when the error
    was <= 0); the loop stops when converged or when no try was accepted.
    Returns (values, err, it): `err` a 0-d tensor where the values live,
    `it` the iterations run, the last one included.

    Values, lambda and the error stay on the device. The loop reads one
    flag pair from it a try (accepted, converged), so one read an
    iteration when the first try is accepted. The JAX scan runs its tries
    after an accepted one too, and they change nothing, so they are
    skipped here; the tries of an iteration share its linearization (the
    JAX program linearizes each at the same values)."""
    _check_supported(params, plan)
    max_it = max_iterations or params.max_iterations
    layout = Layout.of(values)
    err = graph.error(values)
    lam = torch.as_tensor(params.lambda_initial, dtype=err.dtype,
                          device=err.device)
    it = 0
    while it < max_it:
        it += 1
        lin, dd = _linearize(graph, values, params)
        done = True                     # when no try is accepted
        for _ in range(params.max_inner_tries):
            new_values = values.retract(
                _solve(lin, layout, lam, dd, params, plan))
            new_err = graph.error(new_values)
            ok = torch.isfinite(new_err) & (new_err < err)
            abs_dec = err - new_err
            rel_dec = torch.where(err > 0, abs_dec / err, 0.0)
            conv = ((new_err <= params.error_tol)
                    | (abs_dec <= params.absolute_error_tol)
                    | (rel_dec <= params.relative_error_tol))
            accepted, converged = torch.stack([ok, conv]).tolist()
            if accepted:
                values, err, done = new_values, new_err, converged
                break
            lam = lam * params.lambda_factor
        lam = torch.clamp(lam / params.lambda_factor, min=1e-10)
        if done:
            break
    return values, err, it
