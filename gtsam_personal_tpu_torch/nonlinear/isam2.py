"""ISAM2: bounded-cost incremental smoothing with resident device state.

JAX counterpart: gtsam_personal_tpu/nonlinear/isam2.py (all of it; reference:
nonlinear/ISAM2.h:151, ISAM2.cpp:419). The reference keeps a Bayes tree and
re-eliminates only the affected cliques; this engine keeps *cached linear
factors and a warm-started PCG*, under the same bounded-work contract:

  (a) fluid relinearization: per update, variables with |delta_i| > beta
      are retracted into the linearization point theta, and every factor
      row that touches them is linearized again, so the autodiff work of an
      update is O(stale rows), never O(N);
  (b) every other row keeps its cached whitened (J, r) blocks, the analogue
      of the Bayes tree's cached subtree products;
  (c) the delta solve is PCG on the cached system, warm-started from the
      previous delta with an early-exit tolerance, the analogue of wildfire:
      iterations run only while the solution still changes.

Everything lives on the device at capacity size: theta `{g: [cap, *ps]}`,
delta `{g: [cap, d]}`, and per factor type idx `[cap, S]`, measurements,
noise data and the cached rows J `[cap, rdim, d]`, r `[cap, rdim]` (the JAX
package keeps J and r feature-major for the TPU's tiles; the port uses the
layout of linear/linearize.py:LinearBatch). New factors and variables are
scattered into the resident tensors, and capacities grow by doubling, so a
stream rebuilds the device state O(log N) times.

State is functional, as in the JAX package: a tensor that a state holds is
never written in place, an update builds new tensors and a new state.
`clone()` therefore shares the device state between engines for free.

Where the JAX package pads index lists to a power of two and lets the
scatter drop the out-of-range padding (`mode="drop"`), the port sends lists
of their true length (eager torch compiles nothing per shape), relinearizes
a padded bucket of rows and writes back only the live part of it, and adds
masked zeros where a row has no target: no index is ever out of range.

Host reads per update: one for the stale-row counts of all factor types,
one per `PCG_CHECK_EVERY` CG iterations for the stop flag
(linear/solvers.py:pcg_loop), and one for the iteration count.
"""

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import (Values, tree_scale,
                                                  tree_sub, tree_vdot)
from gtsam_personal_tpu_torch.linear import marginal as marg_mod
from gtsam_personal_tpu_torch.linear.linearize import (GaussianGraph,
                                                       LinearBatch,
                                                       linearize_batch)
from gtsam_personal_tpu_torch.linear.noise import (NoiseModel,
                                                   error as noise_error)
from gtsam_personal_tpu_torch.linear.solvers import pcg_loop
from gtsam_personal_tpu_torch.ops import chain

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _bucket(n: int, lo: int) -> int:
    """The least lo * 2^k that is not below n."""
    b = lo
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# device-side state
# ---------------------------------------------------------------------------

class _BatchState:
    """One factor type's capacity tensors, none of them written in place."""

    def __init__(self, name, residual_fn, groups, rdim, noise_kind, robust,
                 idx, meas, noise_data, noise_k, J, r, nfac, needs_lin):
        self.name = name
        self.residual_fn = residual_fn
        self.groups = tuple(groups)
        self.rdim = rdim
        self.noise_kind = noise_kind
        self.robust = robust
        self.idx = idx                # [cap, S] int64
        self.meas = meas              # dict of [cap, ...]
        self.noise_data = noise_data  # [cap, ...] or None (unit)
        self.noise_k = noise_k        # [cap] or None
        self.J = J                    # tuple of [cap, rdim, d_s]; 0 past nfac
        self.r = r                    # [cap, rdim]; 0 past nfac
        self.nfac = nfac              # int: active rows
        self.needs_lin = needs_lin    # bool [cap]

    @property
    def cap(self):
        return self.r.shape[0]

    def active(self):
        return torch.arange(self.cap, device=self.r.device) < self.nfac

    def replace(self, **kw):
        fields = dict(self.__dict__)
        fields.update(kw)
        return _BatchState(**fields)

    def rows(self, rows) -> FactorBatch:
        """The factors of `rows` ([C] int64) as a FactorBatch."""
        noise = NoiseModel(
            self.noise_kind,
            None if self.noise_data is None else self.noise_data[rows],
            self.robust,
            None if self.noise_k is None else self.noise_k[rows])
        return FactorBatch(self.name, self.residual_fn, self.groups,
                           self.rdim, self.idx[rows],
                           {k: v[rows] for k, v in self.meas.items()}, noise)


class _State:
    """theta {g: [cap, *ps]}, delta {g: [cap, d]}, nvar {g: int},
    batches: list of _BatchState."""

    def __init__(self, theta, delta, nvar, batches):
        self.theta = theta
        self.delta = delta
        self.nvar = nvar
        self.batches = batches


@dataclass(frozen=True)
class ISAM2Params:
    """Reference analogue: ISAM2Params (relinearizeThreshold; the CG
    tolerance plays wildfireThreshold's role)."""
    relinearize_threshold: float = 0.01
    lam: float = 1e-6               # constant GN damping (ISAM2GaussNewtonParams)
    # trust region: per-variable cap on the tangent norm of the delta that
    # the solve returns (0 = off), the bounded-cost analogue of
    # ISAM2DoglegParams for stiff chains whose GN step overshoots
    max_delta: float = 0.0
    cg_maxiter: int = 25            # iteration cap per update
    cg_tol: float = 1e-4            # exit when |r| < tol * |r at entry|
    cg_tol_abs: float = 1e-10       # absolute residual floor
    # 'jacobi' | 'chain:<group>' | 'superchain:<g1>+<g2>+...'
    precond: str = "jacobi"
    precond_refresh: int = 10       # rebuild the preconditioner every K updates
    # stale rows are relinearized in one call on a bucket of relin_chunk
    # times a power of two rows, so that the shapes of that call repeat
    relin_chunk: int = 256
    # initial capacity floors, for a stream whose length is known
    min_var_cap: int = 64
    min_fac_cap: int = 64
    dtype: torch.dtype = torch.float64


@dataclass
class ISAM2Result:
    """Per-update stats (reference: ISAM2Result)."""
    factors_total: int = 0
    variables_total: int = 0
    relinearized_rows: int = 0
    cg_iterations: int = 0


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class ISAM2:
    def __init__(self, params: ISAM2Params = ISAM2Params(), *, device):
        self.params = params
        self.device = torch.device(device)
        self._np_dtype = _NP_DTYPE[params.dtype]
        self._pcache = None           # preconditioner cache (device tensors)
        self._updates_since_refresh = 0
        self._theta_host: Dict[str, np.ndarray] = {}
        self._nvar: Dict[str, int] = {}
        self._cap_n: Dict[str, int] = {}
        self._pending_vars: Dict[str, List[int]] = {}
        self._batch_keys: List[tuple] = []
        self._hosts: Dict[tuple, dict] = {}
        self._state: Optional[_State] = None
        self._rebuild = True     # capacity layout changed -> full rebuild
        # bounded-memory eviction (marginalizeLeaves analogue): freed
        # variable slots are recycled by add_variable
        self._free_vars: Dict[str, List[int]] = {}

    def _to_device(self, a):
        """A copy of a host array on the device (`torch.tensor` copies on
        the CPU too, where `as_tensor` would alias the host mirror)."""
        return torch.tensor(a, device=self.device)

    def _identity_rows(self, group, n):
        m = manifolds.get(group)
        ident = m.identity(device="cpu", dtype=self.params.dtype).numpy()
        return np.broadcast_to(ident, (n,) + m.param_shape).copy()

    # -- staging (host) ------------------------------------------------------
    def add_variable(self, group: str, value) -> int:
        dt = self._np_dtype
        if group not in self._theta_host:
            cap = _bucket(self.params.min_var_cap, 64)
            self._theta_host[group] = self._identity_rows(group, cap)
            self._nvar[group] = 0
            self._cap_n[group] = cap
            self._pending_vars[group] = []
            self._rebuild = True
        free = self._free_vars.get(group)
        if free:                      # recycle an evicted slot (bounded cap)
            i = free.pop()
            self._theta_host[group][i] = np.asarray(value, dtype=dt)
            self._pending_vars[group].append(i)
            return i
        if self._nvar[group] + 1 > self._cap_n[group]:
            self._theta_host[group] = np.concatenate(
                [self._theta_host[group],
                 self._identity_rows(group, self._cap_n[group])])
            self._cap_n[group] *= 2
            self._rebuild = True
        i = self._nvar[group]
        self._theta_host[group][i] = np.asarray(value, dtype=dt)
        self._pending_vars[group].append(i)
        self._nvar[group] = i + 1
        return i

    def add_factor(self, name: str, residual_fn: Callable,
                   groups: Sequence[str], rdim: int, idx: Sequence[int],
                   meas: dict, noise: NoiseModel):
        """Append one factor (reference: ISAM2::update newFactors). `noise`
        carries a SINGLE factor's data (no K axis), as tensors or arrays."""
        key = (name, tuple(groups), rdim, noise.kind, noise.robust)
        if key not in self._hosts:
            self._batch_keys.append(key)
            self._hosts[key] = {"residual_fn": residual_fn, "cap": 0, "k": 0,
                                "idx": None, "meas": None, "noise_data": None,
                                "noise_k": None, "pending": []}
            self._rebuild = True
        h = self._hosts[key]
        if h["k"] + 1 > h["cap"]:
            self._grow_batch(key, h, max(_bucket(self.params.min_fac_cap, 64),
                                         h["cap"] * 2), meas, noise)
            self._rebuild = True
        k = h["k"]
        h["idx"][k] = np.asarray(idx, dtype=np.int64)
        for mk, mv in meas.items():
            h["meas"][mk][k] = _as_numpy(mv)
        if noise.data is not None:
            h["noise_data"][k] = _as_numpy(noise.data)
        if noise.k is not None:
            h["noise_k"][k] = _as_numpy(noise.k)
        h["pending"].append(k)
        h["k"] = k + 1

    def _grow_batch(self, key, h, newcap, meas_proto, noise_proto):
        dt = self._np_dtype

        def grown(old, shape, dtype=dt):
            arr = np.zeros((newcap,) + tuple(shape), dtype=dtype)
            if old is not None:
                arr[: old.shape[0]] = old
            return arr

        h["idx"] = grown(h["idx"], (len(key[1]),), np.int64)
        old_meas = h["meas"] or {}
        h["meas"] = {mk: grown(old_meas.get(mk), _as_numpy(mv).shape)
                     for mk, mv in meas_proto.items()}
        if noise_proto.data is not None:
            h["noise_data"] = grown(h["noise_data"],
                                    _as_numpy(noise_proto.data).shape)
        if noise_proto.k is not None:
            h["noise_k"] = grown(h["noise_k"], ())
        h["cap"] = newcap

    # -- device state construction / injection --------------------------------
    def _build_device_state(self):
        """Full (re)build: upload the host mirrors, keeping the resident
        theta, delta and (J, r) caches of the rows that existed. Happens
        O(log N) times per sequence (capacity doubling), and after an
        eviction."""
        dt, dev = self.params.dtype, self.device
        old = self._state
        theta, delta = {}, {}
        for g in self._theta_host:
            d = manifolds.get(g).dim
            cap = self._cap_n[g]
            th = self._to_device(self._theta_host[g])
            dl = torch.zeros((cap, d), dtype=dt, device=dev)
            if old is not None and g in old.theta:
                oc = old.theta[g].shape[0]
                # device theta is the source of truth for the rows it holds
                th[:oc] = old.theta[g]
                dl[:oc] = old.delta[g]
                # pending initial values may lie below oc (recycled slots)
                pend = self._pending_vars[g]
                if pend:
                    th[pend] = self._to_device(self._theta_host[g][pend])
                    dl[pend] = 0.0
            self._pending_vars[g] = []
            theta[g], delta[g] = th, dl

        old_batches = {}
        if old is not None:
            for b in old.batches:
                old_batches[(b.name, b.groups, b.rdim, b.noise_kind,
                             b.robust)] = b
        batches = []
        for key in self._batch_keys:
            name, groups, rdim, nkind, rob = key
            h = self._hosts[key]
            cap, k = h["cap"], h["k"]
            dims = [manifolds.get(g).dim for g in groups]
            J = [torch.zeros((cap, rdim, d), dtype=dt, device=dev)
                 for d in dims]
            r = torch.zeros((cap, rdim), dtype=dt, device=dev)
            needs = torch.zeros((cap,), dtype=torch.bool, device=dev)
            ob = old_batches.get(key)
            if ob is not None:
                # rows past k stay zero: they never enter the solve (after
                # an eviction k is smaller than it was)
                oc = min(ob.cap, k)
                for Jn, Jo in zip(J, ob.J):
                    Jn[:oc] = Jo[:oc]
                r[:oc] = ob.r[:oc]
                needs[:oc] = ob.needs_lin[:oc]
            if h["pending"]:
                needs[h["pending"]] = True
            h["pending"] = []
            batches.append(_BatchState(
                name, h["residual_fn"], groups, rdim, nkind, rob,
                self._to_device(h["idx"]),
                {mk: self._to_device(mv) for mk, mv in h["meas"].items()},
                None if h["noise_data"] is None
                else self._to_device(h["noise_data"]),
                None if h["noise_k"] is None
                else self._to_device(h["noise_k"]),
                tuple(J), r, k, needs))
        self._state = _State(theta, delta, dict(self._nvar), batches)
        self._rebuild = False

    def _inject_pending(self):
        """Scatter newly staged variables and rows into new copies of the
        resident tensors (lists of their true length; no re-upload of the
        rest)."""
        st = self._state
        theta, delta = dict(st.theta), dict(st.delta)
        for g, pend in self._pending_vars.items():
            if not pend:
                continue
            ids = self._to_device(np.asarray(pend, dtype=np.int64))
            theta[g] = theta[g].index_copy(
                0, ids, self._to_device(self._theta_host[g][pend]))
            delta[g] = delta[g].index_fill(0, ids, 0.0)
            self._pending_vars[g] = []
        batches = []
        for key, b in zip(self._batch_keys, st.batches):
            h = self._hosts[key]
            pend = h["pending"]
            if not pend:
                batches.append(b)
                continue
            ids = self._to_device(np.asarray(pend, dtype=np.int64))

            def put(resident, host):
                return resident.index_copy(0, ids,
                                           self._to_device(host[pend]))

            batches.append(b.replace(
                idx=put(b.idx, h["idx"]),
                meas={mk: put(b.meas[mk], h["meas"][mk]) for mk in b.meas},
                noise_data=(b.noise_data if h["noise_data"] is None
                            else put(b.noise_data, h["noise_data"])),
                noise_k=(b.noise_k if h["noise_k"] is None
                         else put(b.noise_k, h["noise_k"])),
                nfac=h["k"],
                needs_lin=b.needs_lin.index_fill(0, ids, True)))
            h["pending"] = []
        self._state = _State(theta, delta, dict(self._nvar), batches)

    # -- the update ------------------------------------------------------------
    def update(self, extra_cg: int = 0) -> ISAM2Result:
        """Inject staged factors and values, relinearize stale rows, solve
        delta again. Reference: ISAM2::update."""
        added_vars = any(self._pending_vars.values())
        if self._rebuild:
            self._build_device_state()
            self._pcache = None      # capacity shapes changed
        else:
            self._inject_pending()
        # a cached preconditioner is only valid for the variables it saw: a
        # new variable's block is zero in the stale cache and inverts to
        # ~1/lam * I, which mis-scales stiff factor chains badly (the JAX
        # package measured divergence of IMU+GPS fusion). Rebuild whenever
        # variables appear.
        use_cache = (self._pcache is not None
                     and not added_vars
                     and self._updates_since_refresh
                     < self.params.precond_refresh)
        p = self.params
        st, relin_rows, cg_it, self._pcache = _isam2_update(
            self._state, p.relinearize_threshold, p.lam,
            p.cg_maxiter + extra_cg, p.cg_tol, p.cg_tol_abs, p.relin_chunk,
            p.precond, self._pcache if use_cache else None, p.max_delta)
        self._updates_since_refresh = (self._updates_since_refresh + 1
                                       if use_cache else 1)
        self._state = st
        return ISAM2Result(
            factors_total=sum(h["k"] for h in self._hosts.values()),
            variables_total=sum(self._nvar.values()),
            relinearized_rows=relin_rows,
            cg_iterations=cg_it)

    # -- queries ---------------------------------------------------------------
    def _flush_staged(self):
        if self._rebuild:
            self._build_device_state()
        elif (any(self._pending_vars.values())
              or any(h["pending"] for h in self._hosts.values())):
            self._inject_pending()

    def calculate_estimate(self) -> Values:
        """theta [+] delta (reference: ISAM2::calculateEstimate)."""
        self._flush_staged()
        st = self._state
        return Values({g: _estimate(st, g)[: self._nvar[g]]
                       for g in st.theta})

    def error(self) -> float:
        """Nonlinear error at the current estimate."""
        self._flush_staged()
        return float(_isam2_error(self._state))

    def marginalize_variables(self, marg: Dict[str, Sequence[int]]):
        """In-engine eviction, the analogue of the reference's
        ISAM2::marginalizeLeaves (nonlinear/ISAM2.h:199) and
        IncrementalFixedLagSmoother.

        Factor rows that touch the evicted variables are Schur-complemented
        (at the current estimate theta [+] delta) into ONE dense Gaussian
        prior over their Markov blanket, which re-enters through the normal
        staging path; the rows are removed (host mirrors compacted, every
        surviving row marked for relinearization), and the evicted variable
        slots join a free list that add_variable recycles, so an unbounded
        stream runs at bounded device memory. The cost of an eviction is
        O(window), not O(stream).

        The boundary's (groups, dim) signature keys the marginal's batch: a
        stream whose eviction boundary is stable (chains, fixed-lag windows)
        re-uses one batch."""
        self._flush_staged()
        est = self.calculate_estimate()
        marg_sets = {g: set(map(int, ix)) for g, ix in marg.items()}

        involved, removals = [], {}
        for key in self._batch_keys:
            h = self._hosts[key]
            name, groups, rdim, nkind, rob = key
            k = h["k"]
            if k == 0:
                continue
            idx = h["idx"][:k]
            hit = np.zeros(k, dtype=bool)
            for s, g in enumerate(groups):
                if marg_sets.get(g):
                    hit |= np.isin(idx[:, s], list(marg_sets[g]))
            rows = np.where(hit)[0]
            if rows.size == 0:
                continue
            removals[key] = rows
            involved.append(FactorBatch(
                name, h["residual_fn"], groups, rdim,
                self._to_device(idx[rows]),
                {mk: self._to_device(mv[rows])
                 for mk, mv in h["meas"].items()},
                NoiseModel(nkind,
                           None if h["noise_data"] is None
                           else self._to_device(h["noise_data"][rows]),
                           rob,
                           None if h["noise_k"] is None
                           else self._to_device(h["noise_k"][rows]))))

        if involved:
            _, mbatch, bound = marg_mod.marginalize(
                FactorGraph(involved), est, marg)
            for key, rows in removals.items():
                self._remove_rows(key, rows)
            if mbatch is not None:
                self.add_factor(mbatch.name, mbatch.residual_fn,
                                mbatch.groups, mbatch.rdim,
                                [i for _, i in bound],
                                {mk: mv[0] for mk, mv in mbatch.meas.items()},
                                NoiseModel("unit"))
        for g, ids in marg_sets.items():
            self._free_vars.setdefault(g, []).extend(sorted(ids))
        self._rebuild = True

    def _remove_rows(self, key, rows):
        """Compact a host batch mirror after an eviction: surviving rows
        slide down, and every row is marked pending (the cached device
        (J, r) blocks no longer line up and must relinearize once)."""
        h = self._hosts[key]
        keep = np.setdiff1d(np.arange(h["k"]), rows)
        kk = len(keep)
        h["idx"][:kk] = h["idx"][keep]
        for mk in h["meas"]:
            h["meas"][mk][:kk] = h["meas"][mk][keep]
        if h["noise_data"] is not None:
            h["noise_data"][:kk] = h["noise_data"][keep]
        if h["noise_k"] is not None:
            h["noise_k"][:kk] = h["noise_k"][keep]
        h["k"] = kk
        h["pending"] = list(range(kk))

    def clone(self) -> "ISAM2":
        """Cheap fork of the engine (hypothesis branching for hybrid
        inference). The device state and the preconditioner cache are never
        written in place, updates replace them, so they are shared; the host
        staging mirrors are copied."""
        c = ISAM2(self.params, device=self.device)
        c._pcache = self._pcache
        c._updates_since_refresh = self._updates_since_refresh
        c._theta_host = {g: a.copy() for g, a in self._theta_host.items()}
        c._nvar = dict(self._nvar)
        c._cap_n = dict(self._cap_n)
        c._pending_vars = {g: list(v) for g, v in self._pending_vars.items()}
        c._batch_keys = list(self._batch_keys)
        c._hosts = {}
        for k, h in self._hosts.items():
            c._hosts[k] = {
                "residual_fn": h["residual_fn"], "cap": h["cap"], "k": h["k"],
                "idx": None if h["idx"] is None else h["idx"].copy(),
                "meas": (None if h["meas"] is None
                         else {mk: mv.copy() for mk, mv in h["meas"].items()}),
                "noise_data": (None if h["noise_data"] is None
                               else h["noise_data"].copy()),
                "noise_k": (None if h["noise_k"] is None
                            else h["noise_k"].copy()),
                "pending": list(h["pending"]),
            }
        c._state = self._state
        c._rebuild = self._rebuild
        c._free_vars = {g: list(v) for g, v in self._free_vars.items()}
        return c

    def estimate_array(self, group: str) -> np.ndarray:
        return self.calculate_estimate()[group].cpu().numpy()

    def estimate_at(self, group: str, i: int) -> np.ndarray:
        """O(1) single-variable estimate (streaming init helper)."""
        self._flush_staged()
        st = self._state
        m = manifolds.get(group)
        return m.retract(st.theta[group][i], st.delta[group][i]).cpu().numpy()


def _as_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _estimate(st: _State, g: str):
    return manifolds.batched_retract(manifolds.get(g), st.theta[g],
                                     st.delta[g])


# ---------------------------------------------------------------------------
# the update
# ---------------------------------------------------------------------------

def _isam2_update(st: _State, beta, lam, cg_maxiter, cg_tol, cg_tol_abs,
                  relin_chunk, precond_kind="jacobi", pcache=None,
                  max_delta=0.0):
    """(new state, relinearized rows, CG iterations, preconditioner cache);
    `pcache` is the cache to reuse, or None to build one."""
    dev = next(iter(st.theta.values())).device
    # ---- 1. fluid relinearization: variables with |delta| > beta ----
    relin_var, theta, delta = {}, {}, {}
    for g in st.theta:
        m = manifolds.get(g)
        d_g = st.delta[g]
        act = torch.arange(d_g.shape[0], device=dev) < st.nvar[g]
        mask = ((d_g * d_g).sum(1) > beta * beta) & act
        zero = torch.zeros_like(d_g)
        theta[g] = manifolds.batched_retract(
            m, st.theta[g], torch.where(mask[:, None], d_g, zero))
        delta[g] = torch.where(mask[:, None], zero, d_g)
        relin_var[g] = mask

    # ---- 2. stale rows = needs_lin | incident to relinearized vars ----
    stales = []
    for b in st.batches:
        stale = b.needs_lin
        for s, g in enumerate(b.groups):
            stale = stale | relin_var[g][b.idx[:, s]]
        stales.append(stale & b.active())
    counts = torch.stack([s.sum() for s in stales]).tolist()   # host read
    values = Values(theta)
    new_batches = []
    for b, stale, n in zip(st.batches, stales, counts):
        J, r = b.J, b.r
        if n > 0:
            # the first `size` stale rows in order, padded with row 0; the
            # padding is linearized with the rest and not written back
            rows = torch.nonzero_static(
                stale, size=_bucket(n, relin_chunk), fill_value=0)[:, 0]
            lb = linearize_batch(b.rows(rows), values)
            live = rows[:n]
            r = r.index_copy(0, live, lb.r[:n])
            J = tuple(Js.index_copy(0, live, Jw[:n])
                      for Js, Jw in zip(J, lb.Js))
        new_batches.append(b.replace(
            J=J, r=r, needs_lin=torch.zeros_like(b.needs_lin)))

    # ---- 3. warm-started PCG on the cached system (wildfire analogue) ----
    counts_n = {g: int(st.delta[g].shape[0]) for g in st.delta}
    lin = GaussianGraph([LinearBatch(b.groups, b.idx, b.J, b.r)
                         for b in new_batches], counts_n)
    b_rhs = tree_scale(lin.gradient_at_zero(), -1.0)

    def matvec(x):
        hx = lin.hessian_vector_product(x)
        return {g: hx[g] + lam * x[g] for g in hx}

    if pcache is None:
        pcache = _build_precond_cache(lin, st.nvar, lam, precond_kind)
    precond = lambda r: _apply_precond(pcache, precond_kind, r)
    delta_new, cg_it = _pcg_counting(matvec, b_rhs, precond, delta,
                                     cg_maxiter, cg_tol, cg_tol_abs)
    if max_delta > 0.0:
        # per-variable trust region: scale each variable's tangent so that
        # its norm is <= max_delta (keeps the direction, bounds the GN step)
        for g, d_g in delta_new.items():
            nrm = torch.sqrt((d_g * d_g).sum(1, keepdim=True))
            delta_new[g] = d_g * torch.clamp(
                max_delta / torch.clamp(nrm, min=1e-30), max=1.0)
    return (_State(theta, delta_new, st.nvar, new_batches), sum(counts),
            cg_it, pcache)


# ---------------------------------------------------------------------------
# preconditioners
# ---------------------------------------------------------------------------

def _build_precond_cache(lin: GaussianGraph, nvar: Dict[str, int], lam,
                         kind: str):
    """'jacobi': per-variable block diagonal. 'chain:<group>': block-
    tridiagonal along <group>'s index chain (the spanning-subgraph / SPCG
    preconditioner, reference: SubgraphPreconditioner,
    linear/SubgraphSolver.h:76, made incremental). 'superchain:<g1>+<g2>+...':
    block-tridiagonal over the COMBINED per-timestep state of several groups
    that share one index (se3+vel3+imu_bias for VIO: 15-dim blocks), exact
    for pure odometric chains, which is what makes stiff preintegrated-IMU
    fusion converge (block-Jacobi cannot move information along the chain).
    The cache is reused for `precond_refresh` updates (a stale SPD
    preconditioner is still a valid preconditioner)."""
    blocks = lin.hessian_block_diagonal()
    if kind.startswith("superchain:"):
        groups = tuple(kind[len("superchain:"):].split("+"))
        D, O = _superchain_harvest(lin, groups)
        n = nvar[groups[0]]
    elif kind.startswith("chain:"):
        groups = (kind[len("chain:"):],)
        D, O = blocks[groups[0]], _chain_offdiag(lin, groups[0])
        n = nvar[groups[0]]
    else:
        return {"inv": _invert_blocks(blocks, lam)}
    Dm, Om = chain.chain_prepare(D, O, n, lam)
    Uinv = chain.chain_factorize(Dm, Om)
    Tf, Tb = chain.chain_scan_templates(Uinv, Om)
    others = {g: B for g, B in blocks.items() if g not in groups}
    return {"Uinv": Uinv, "Tf": Tf, "Tb": Tb,
            "inv": _invert_blocks(others, lam)}


def _super_offsets(groups):
    offs, off = {}, 0
    for g in groups:
        offs[g] = off
        off += manifolds.get(g).dim
    return offs, off


def _superchain_harvest(lin: GaussianGraph, groups):
    """The block-tridiagonal Hessian of the combined per-timestep state:
    D_i = H[(., i), (., i)] (all group pairs at timestep i, [cap, D, D]) and
    O_i = H[(., i), (., i+1)]. The groups share one capacity (one variable
    of each group per timestep)."""
    offs, D = _super_offsets(groups)
    caps = {g: lin.counts[g] for g in groups}
    if len(set(caps.values())) != 1:
        raise ValueError(f"superchain groups must share capacity, got {caps}")
    cap = caps[groups[0]]
    r0 = lin.batches[0].r
    Dm = r0.new_zeros((cap, D, D))
    Om = r0.new_zeros((cap, D, D))
    for b in lin.batches:
        for s, gs in enumerate(b.groups):
            if gs not in offs:
                continue
            ds = manifolds.get(gs).dim
            for t, gt in enumerate(b.groups):
                if gt not in offs:
                    continue
                dt = manifolds.get(gt).dim
                C = torch.einsum("kij,kil->kjl", b.Js[s], b.Js[t])
                ii, jj = b.idx[:, s], b.idx[:, t]
                zero = torch.zeros_like(C)
                # a row with no target adds zeros to block ii
                for target, hit in ((Dm, jj == ii), (Om, jj == ii + 1)):
                    target[:, offs[gs]:offs[gs] + ds,
                           offs[gt]:offs[gt] + dt].index_add_(
                        0, ii, torch.where(hit[:, None, None], C, zero))
    return Dm, Om


def _invert_blocks(blocks, lam):
    inv = {}
    for g, B in blocks.items():
        eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
        inv[g] = torch.linalg.inv(B + (lam + 1e-10) * eye)
    return inv


def _apply_precond(cache, kind: str, r):
    out = {g: torch.bmm(I, r[g][:, :, None])[:, :, 0]
           for g, I in cache["inv"].items()}
    if kind.startswith("superchain:"):
        groups = tuple(kind[len("superchain:"):].split("+"))
        offs, _ = _super_offsets(groups)
        cap = cache["Uinv"].shape[0]
        x = chain.chain_apply(
            cache["Uinv"], cache["Tf"], cache["Tb"],
            torch.cat([r[g][:cap] for g in groups], dim=1))
        for g in groups:
            xg = x[:, offs[g]:offs[g] + manifolds.get(g).dim]
            if r[g].shape[0] > cap:
                # rows beyond the cached chain capacity pass through (these
                # groups have no block-Jacobi inverse): zero-filling would
                # make the preconditioner singular for those variables if a
                # stale cache were ever applied after capacity growth
                xg = torch.cat([xg, r[g][cap:]])
            out[g] = xg
    elif kind.startswith("chain:"):
        cgroup = kind[len("chain:"):]
        out[cgroup] = chain.chain_apply(cache["Uinv"], cache["Tf"],
                                        cache["Tb"], r[cgroup])
    return out


def _chain_offdiag(lin: GaussianGraph, group: str):
    """The consecutive-coupling blocks H_{i,i+1} of `group`, [cap, d, d]
    (block i couples i and i+1)."""
    d = manifolds.get(group).dim
    O = lin.batches[0].r.new_zeros((lin.counts[group], d, d))
    for b in lin.batches:
        for s in range(len(b.groups)):
            for t in range(len(b.groups)):
                if s == t or b.groups[s] != group or b.groups[t] != group:
                    continue
                ii, jj = b.idx[:, s], b.idx[:, t]
                consec = jj == ii + 1
                C = torch.einsum("kij,kil->kjl", b.Js[s], b.Js[t])  # H_{ii,jj}
                # a row that is not consecutive adds zeros to block ii
                O.index_add_(0, ii, torch.where(consec[:, None, None], C,
                                                torch.zeros_like(C)))
    return O


def _pcg_counting(matvec, b, precond, x0, maxiter, tol, tol_abs=0.0):
    """Warm-started PCG; returns (x, iterations used). The early-exit
    tolerance is the wildfire analogue: iterations stop once the residual
    has shrunk by `tol` relative to THIS update's entry residual (with an
    absolute floor for systems that are already converged, such as pure
    odometry, where the composed start is exact)."""
    r0 = tree_sub(b, matvec(x0))
    threshold = torch.clamp(tol * tol * tree_vdot(r0, r0),
                            min=tol_abs * tol_abs)
    x, used = pcg_loop(matvec, precond, x0, r0, threshold, maxiter)
    return x, int(used)


def _isam2_error(st: _State):
    """Nonlinear error at theta [+] delta over all active factor rows."""
    est = {g: _estimate(st, g) for g in st.theta}
    total = st.batches[0].r.new_zeros(())
    for b in st.batches:
        pts = tuple(est[g][b.idx[:, s]] for s, g in enumerate(b.groups))
        r = torch.func.vmap(b.residual_fn)(pts, b.meas)
        r = torch.where(b.active()[:, None], r, torch.zeros_like(r))
        noise = NoiseModel(b.noise_kind, b.noise_data, b.robust, b.noise_k)
        total = total + noise_error(noise, r)
    return total
