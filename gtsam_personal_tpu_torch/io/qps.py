"""QPS (quadratic MPS) parser.

Reference parity: gtsam_unstable/linear/QPSParser.{h,cpp} — parses the QPS
files shipped in examples/Data (QPTEST.QPS, HS21.QPS, ...) into the arrays
`linear/lpqp.solve_qp` consumes:

  min 0.5 x^T G x + g^T x + c   s.t.  A_eq x = b_eq,  A_in x <= b_in

Sections handled: ROWS (N/E/G/L), COLUMNS, RHS, RANGES, BOUNDS (UP/LO/FX/FR/
MI/PL/BV-free subset the reference supports), QUADOBJ/QMATRIX. G-rows and
lower bounds are flipped into <= form; FX bounds become equalities; default
bound is x >= 0 (MPS convention, matching the reference's fx/lb handling).

JAX counterpart: gtsam_personal_tpu/io/qps.py (all of it). The parser is
host numpy; `solve_qps` runs the port's linear/lpqp.py:solve_qp, which
solves on the host in float64 as the JAX package's does.
"""

from typing import Dict, NamedTuple, Optional

import numpy as np

from gtsam_personal_tpu_torch.linear.lpqp import solve_qp


class QP(NamedTuple):
    G: np.ndarray            # [n, n] quadratic term (symmetric)
    g: np.ndarray            # [n] linear term
    c: float                 # constant term
    A_eq: np.ndarray         # [me, n]
    b_eq: np.ndarray         # [me]
    A_in: np.ndarray         # [mi, n] rows of A_in x <= b_in
    b_in: np.ndarray         # [mi]
    var_names: tuple
    row_names: tuple


def parse_qps(path: str) -> QP:
    rows: Dict[str, str] = {}          # name -> N/E/G/L
    obj_row: Optional[str] = None
    col_order = []
    entries: Dict[str, Dict[str, float]] = {}   # row -> {col: coeff}
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    quad: Dict[tuple, float] = {}
    lb: Dict[str, float] = {}
    ub: Dict[str, float] = {}
    free: set = set()
    fixed: Dict[str, float] = {}

    section = None
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip() or line.strip().startswith("*"):
                continue
            tok = line.split()
            head = tok[0].upper()
            if head in ("NAME", "ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS",
                        "QUADOBJ", "QMATRIX", "ENDATA") and (
                    not line[0].isspace() or head in ("ROWS", "ENDATA")):
                section = head
                continue
            if section == "ROWS":
                kind, name = tok[0].upper(), tok[1]
                if kind == "N":
                    if obj_row is None:
                        obj_row = name
                else:
                    rows[name] = kind
            elif section == "COLUMNS":
                col = tok[0]
                if col not in entries.setdefault("__cols__", {}):
                    entries["__cols__"][col] = len(col_order)
                    col_order.append(col)
                for i in range(1, len(tok) - 1, 2):
                    entries.setdefault(tok[i], {})[col] = float(tok[i + 1])
            elif section == "RHS":
                for i in range(1, len(tok) - 1, 2):
                    rhs[tok[i]] = float(tok[i + 1])
            elif section == "RANGES":
                for i in range(1, len(tok) - 1, 2):
                    ranges[tok[i]] = float(tok[i + 1])
            elif section == "BOUNDS":
                btype = tok[0].upper()
                # tok[1] is the bound-set name
                var = tok[2]
                val = float(tok[3]) if len(tok) > 3 else 0.0
                if btype == "UP":
                    ub[var] = val
                elif btype == "LO":
                    lb[var] = val
                elif btype == "FX":
                    fixed[var] = val
                elif btype in ("FR", "MI"):
                    free.add(var)
                elif btype == "PL":
                    pass
            elif section in ("QUADOBJ", "QMATRIX"):
                quad[(tok[0], tok[1])] = float(tok[2])

    entries.pop("__cols__", None)
    n = len(col_order)
    cidx = {cn: i for i, cn in enumerate(col_order)}

    G = np.zeros((n, n))
    for (ci, cj), v in quad.items():
        i, j = cidx[ci], cidx[cj]
        G[i, j] = v
        G[j, i] = v
    g = np.zeros(n)
    c = 0.0
    if obj_row is not None:
        for col, v in entries.pop(obj_row, {}).items():
            g[cidx[col]] = v
        c = -rhs.get(obj_row, 0.0)   # MPS: RHS of objective = negated constant

    A_eq_rows, b_eq, A_in_rows, b_in = [], [], [], []
    row_names = []
    for name, kind in rows.items():
        coeffs = entries.get(name, {})
        a = np.zeros(n)
        for col, v in coeffs.items():
            a[cidx[col]] = v
        b = rhs.get(name, 0.0)
        row_names.append(name)
        if kind == "E":
            A_eq_rows.append(a)
            b_eq.append(b)
        elif kind == "L":
            A_in_rows.append(a)
            b_in.append(b)
            if name in ranges:                # L with range r: b - |r| <= ax
                A_in_rows.append(-a)
                b_in.append(-(b - abs(ranges[name])))
        elif kind == "G":
            A_in_rows.append(-a)
            b_in.append(-b)
            if name in ranges:                # G with range r: ax <= b + |r|
                A_in_rows.append(a)
                b_in.append(b + abs(ranges[name]))

    # variable bounds: default x >= 0 unless freed/lower-bounded/fixed
    for cn in col_order:
        i = cidx[cn]
        e = np.zeros(n)
        e[i] = 1.0
        if cn in fixed:
            A_eq_rows.append(e)
            b_eq.append(fixed[cn])
            continue
        lo = lb.get(cn, None if cn in free else 0.0)
        if lo is not None:
            A_in_rows.append(-e)
            b_in.append(-lo)
        if cn in ub:
            A_in_rows.append(e)
            b_in.append(ub[cn])

    def stack(lst, width):
        return (np.asarray(lst).reshape(len(lst), width) if lst
                else np.zeros((0, width)))

    return QP(G, g, c, stack(A_eq_rows, n), np.asarray(b_eq, dtype=float),
              stack(A_in_rows, n), np.asarray(b_in, dtype=float),
              tuple(col_order), tuple(row_names))


def solve_qps(path: str):
    """Parse + solve: returns (x, objective incl. the file's constant)."""
    qp = parse_qps(path)
    res = solve_qp(qp.G, qp.g,
                   A_eq=qp.A_eq if qp.A_eq.size else None,
                   b_eq=qp.b_eq if qp.b_eq.size else None,
                   A_in=qp.A_in if qp.A_in.size else None,
                   b_in=qp.b_in if qp.b_in.size else None)
    x = np.asarray(res.x)
    obj = 0.5 * x @ qp.G @ x + qp.g @ x + qp.c
    return x, obj
