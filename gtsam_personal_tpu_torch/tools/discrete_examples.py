"""Discrete-inference examples: Asia Bayes net, HMM chain, UGM-style MRF.

    python -m gtsam_personal_tpu_torch.tools.discrete_examples
        [--device cuda]

JAX counterpart: examples/discrete_examples.py, with the same printed
lines. Mirrors the reference's DiscreteBayesNetExample.cpp /
HMMExample.cpp / UGM_chain.cpp / UGM_small.cpp on the dense-table discrete
layer (discrete/discrete.py). Every inference result is cross-checked
against brute-force enumeration in this script. The tables live on the
card unless `--device cpu` asks for the CPU.
"""

import argparse
import itertools

import numpy as np

from gtsam_personal_tpu_torch.discrete.discrete import (DiscreteFactorGraph,
                                                        parse_signature)


def brute_force_best(factors_or_bn, variables, cards, evaluate):
    best, best_p = None, -1.0
    for combo in itertools.product(*[range(cards[v]) for v in variables]):
        a = dict(zip(variables, combo))
        p = evaluate(a)
        if p > best_p:
            best, best_p = a, p
    return best, best_p


def asia_network(device="cuda", say=print):
    """The classic Asia network via Signature-string CPTs (reference:
    DiscreteBayesNetExample.cpp)."""
    A, S, T, L, B, E, X, D = range(8)
    conds = [
        parse_signature("99/1", A, (), None, device),
        parse_signature("50/50", S, (), None, device),
        parse_signature("99/1 95/5", T, (A,), (2,), device),
        parse_signature("99/1 90/10", L, (S,), (2,), device),
        parse_signature("70/30 40/60", B, (S,), (2,), device),
        # Either = T or L (deterministic OR)
        parse_signature("1/0 0/1 0/1 0/1", E, (T, L), (2, 2), device),
        parse_signature("95/5 2/98", X, (E,), (2,), device),
        parse_signature("9/1 2/8 3/7 1/9", D, (E, B), (2, 2), device),
    ]
    g = DiscreteFactorGraph(device)
    for c in conds:
        # conditional table has frontal axis FIRST: factor vars = (f, *parents)
        g.add((c.frontal,) + tuple(c.parents), c.table)

    names = "Asia Smoking Tuberculosis LungCancer Bronchitis Either XRay Dyspnea".split()
    cards = {v: 2 for v in range(8)}

    mpe = g.optimize()
    bf, bf_p = brute_force_best(g, list(range(8)), cards, g.evaluate)
    say(f"Asia MPE: {({names[v]: mpe[v] for v in sorted(mpe)})}")
    assert all(mpe[v] == bf[v] for v in range(8)), (mpe, bf)

    mB = g.marginal(B).cpu().numpy()
    # brute-force marginal
    tot = np.zeros(2)
    for combo in itertools.product(range(2), repeat=8):
        a = dict(zip(range(8), combo))
        tot[a[B]] += g.evaluate(a)
    np.testing.assert_allclose(mB, tot / tot.sum(), atol=1e-10)
    say(f"P(Bronchitis) = {mB[1]:.4f} (brute-force match)")

    # posterior given evidence Dyspnea=1: condition by adding an indicator
    g2 = DiscreteFactorGraph(device)
    for c in conds:
        g2.add((c.frontal,) + tuple(c.parents), c.table)
    g2.add((D,), np.array([0.0, 1.0]))
    mT = g2.marginal(T).cpu().numpy()
    say(f"P(Tuberculosis | Dyspnea=1) = {mT[1]:.4f}")
    assert mT[1] > g.marginal(T).cpu().numpy()[1]  # evidence raises suspicion
    return True


def hmm_chain(n=5, device="cuda", say=print):
    """HMM max-product decode (reference: HMMExample.cpp)."""
    rng = np.random.default_rng(0)
    trans = np.array([[0.8, 0.2], [0.3, 0.7]])     # [from, to]
    emit = np.array([[0.9, 0.1], [0.2, 0.8]])      # [state, obs]
    obs = rng.integers(0, 2, size=n)
    g = DiscreteFactorGraph(device)
    g.add((0,), np.array([0.5, 0.5]) * emit[:, obs[0]])
    for i in range(1, n):
        g.add((i - 1, i), trans)
        g.add((i,), emit[:, obs[i]])
    mpe = g.optimize()
    cards = {v: 2 for v in range(n)}
    bf, _ = brute_force_best(g, list(range(n)), cards, g.evaluate)
    assert all(mpe[v] == bf[v] for v in range(n)), (mpe, bf)
    say(f"HMM obs={obs.tolist()} -> Viterbi states "
        f"{[mpe[v] for v in range(n)]} (brute-force match)")
    return True


def ugm_chain(n=6, card=3, device="cuda", say=print):
    """Chain MRF marginals + partition function (reference: UGM_chain.cpp)."""
    rng = np.random.default_rng(1)
    g = DiscreteFactorGraph(device)
    unary = rng.uniform(0.5, 2.0, size=(n, card))
    pair = rng.uniform(0.5, 2.0, size=(n - 1, card, card))
    for i in range(n):
        g.add((i,), unary[i])
    for i in range(n - 1):
        g.add((i, i + 1), pair[i])
    m0 = g.marginal(0).cpu().numpy()
    tot = np.zeros(card)
    Z = 0.0
    for combo in itertools.product(range(card), repeat=n):
        a = dict(zip(range(n), combo))
        p = g.evaluate(a)
        tot[a[0]] += p
        Z += p
    np.testing.assert_allclose(m0, tot / tot.sum(), atol=1e-10)
    say(f"UGM chain: P(x0) = {np.round(m0, 4).tolist()}, Z = {Z:.4f} "
        f"(brute-force match)")
    return True


def run(device="cuda", say=print):
    """The three examples; True when every check held."""
    ok = (asia_network(device, say) and hmm_chain(device=device, say=say)
          and ugm_chain(device=device, say=say))
    say("DISCRETE-EXAMPLES OK" if ok else "DISCRETE-EXAMPLES FAIL")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return 0 if run(ap.parse_args(argv).device) else 1


if __name__ == "__main__":
    raise SystemExit(main())
