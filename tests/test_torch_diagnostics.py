"""The port's linear-system diagnosis (linear/diagnostics.py) against the
JAX package's, in float64 on the CPU: the three cases of
tests/test_diagnostics.py with the two reports equal, and optimize_lm's
diagnosis on a failure, printed alike by both packages."""

import jax.numpy as jnp
import numpy as np
import pytest

from gtsam_personal_tpu.core.graph import GraphBuilder as JGraphBuilder
from gtsam_personal_tpu.core.values import Values as JValues
from gtsam_personal_tpu.linear import diagnostics as jdiag
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu.slam import factors as JF
from gtsam_personal_tpu_torch.linear import diagnostics
from gtsam_personal_tpu_torch.nonlinear import optimizers as opt
from test_torch_graph import port_graph, port_values


def _chain(n=4, with_prior=True, orphan=False, nan=False):
    """tests/test_diagnostics.py's graphs, in both packages."""
    b = JGraphBuilder()
    if with_prior:
        JF.add_prior(b, "se2", 0, np.zeros(3), JF.diag_noise([1.0] * 3))
    for i in range(n - 1):
        meas = np.array([np.nan if nan else 1.0, 0.0, 0.0])
        JF.add_between(b, "se2", i, i + 1, meas,
                       JF.diag_noise([0.1, 0.1, 0.05]))
    m = n + 1 if orphan else n      # an extra variable no factor touches
    vals = (np.zeros((m, 3)) if nan else np.random.default_rng(0).normal(
        scale=0.1, size=(m, 3)))
    jg, jv = b.build(), JValues({"se2": jnp.asarray(vals)})
    return jg, jv, port_graph(jg), port_values(jv)


def _same(rep, jrep):
    assert rep.ok == jrep.ok
    assert rep.nonfinite_factors == jrep.nonfinite_factors
    assert [(g, i) for g, i, _ in rep.singular_variables] == \
        [(g, i) for g, i, _ in jrep.singular_variables]
    np.testing.assert_allclose([e for *_, e in rep.singular_variables],
                               [e for *_, e in jrep.singular_variables],
                               rtol=1e-9, atol=1e-12)
    assert rep.min_block_eig == pytest.approx(jrep.min_block_eig, rel=1e-9)
    assert str(rep) == str(jrep)


def test_healthy_system_reports_ok():
    jg, jv, g, v = _chain()
    rep = diagnostics.diagnose(g, v)
    assert rep.ok
    assert rep.min_block_eig > 1e-6
    rep.raise_if_bad()                # a no-op
    _same(rep, jdiag.diagnose(jg, jv))


def test_orphan_variable_named():
    jg, jv, g, v = _chain(orphan=True)
    rep = diagnostics.diagnose(g, v)
    assert not rep.ok
    assert ("se2", 4) in [(g_, i) for g_, i, _ in rep.singular_variables]
    with pytest.raises(diagnostics.IndeterminantLinearSystemError) as exc:
        rep.raise_if_bad()
    assert exc.value.report is rep
    assert "se2[4]" in str(rep)
    _same(rep, jdiag.diagnose(jg, jv))


def test_nonfinite_measurement_named():
    jg, jv, g, v = _chain(n=2, nan=True)
    rep = diagnostics.diagnose(g, v)
    # a linearized batch carries no name: it is named by its groups
    assert rep.nonfinite_factors == [("se2+se2", 0)], str(rep)
    _same(rep, jdiag.diagnose(jg, jv))


def test_optimize_lm_prints_the_diagnosis(capsys):
    """An orphan variable and no damping: every try is NaN, LM gives up and
    prints the report that names the orphan, as the JAX package does."""
    jg, jv, g, v = _chain(orphan=True)
    res = opt.optimize_lm(g, v, opt.Params(lambda_initial=0.0))
    out = capsys.readouterr().out
    jres = jopt.optimize_lm(jg, jv, jopt.Params(lambda_initial=0.0))
    jout = capsys.readouterr().out
    assert not res.converged and not jres.converged
    assert res.iterations == jres.iterations == 0
    assert "SINGULAR/INDEFINITE block for variable se2[4]" in out
    assert out == jout
    opt.optimize_lm(g, v, opt.Params(lambda_initial=0.0,
                                     diagnose_on_failure=False))
    assert capsys.readouterr().out == ""
