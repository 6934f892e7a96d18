"""Checkpoint and resume: Values, factor graphs, the LM carry and a whole
ISAM2 engine.

JAX counterpart: gtsam_personal_tpu/utils/serialization.py (save/load_values,
save/load_graph, save/load_lm_carry, save/load_isam2; reference: the
boost::serialization snapshots of examples/SolverComparer.cpp:416-519).

The port's format is one `.npz` archive, read with `allow_pickle=False`: a
JSON header in the entry `__header__` says what the file holds and names
the arrays `a0`, `a1`, ... that hold the numbers. Group names live in the
header, so any name round-trips (the JAX package's `load_lm_carry` drops a
group whose name starts with `__`); lambda and the error of the LM carry are
header numbers (a Python float holds a float32 or float64 exactly).

Residual functions are code, not data: a file records each batch's name,
groups and the residual's qualified name, and `resolve_residual` finds the
function again through `register_residual` or
slam/factors.py:residual_by_name, never by importing a module that a file
names and never by unpickling. A residual that neither knows raises
KeyError; one whose factory's closure held more than its groups (partial
prior, bounding constraint) raises ValueError from residual_by_name.

The loaders also read what the JAX package's `save_values`, `save_graph`
(the `.npz` and its `.json` header beside it) and `save_lm_carry` write:
that is how a graph crosses from the JAX package.
"""

import dataclasses
import json
from typing import Callable, Dict

import numpy as np
import torch

from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear.marginal import make_marginal_residual
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.slam import factors as F

FORMAT = "gtsam_personal_tpu_torch/1"
_REGISTRY: Dict[str, Callable] = {}
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def register_residual(name: str, fn: Callable):
    """Resolve batches named `name` to `fn` when a file is loaded (it comes
    before every other rule)."""
    _REGISTRY[name] = fn


# factories whose closure holds only what the batch's groups say: the
# residual_by_name name of a batch, from its groups
_FACTORY_NAMES = {
    "make_prior_residual": lambda g: f"prior_{g[0]}",
    "make_between_residual": lambda g: f"between_{g[0]}",
    "make_between_sensor_residual": lambda g: f"between_sensor_{g[0]}",
    "make_prior_sensor_residual": lambda g: f"prior_sensor_{g[0]}",
    "make_between_em_residual": lambda g: f"between_em_{g[0]}",
    "make_reference_frame_residual": lambda g: f"reference_frame_{g[1]}",
    "make_partial_prior_residual": lambda g: f"partial_prior_{g[0]}",
    "make_bounding_constraint_residual": lambda g: "bounding_constraint",
}


def resolve_residual(name: str, groups=(), qualname: str = None):
    """The residual function of a batch `name` over `groups` whose function
    had the qualified name `qualname`: a registered one, else the factory or
    module-level function that the qualified name points to among the
    port's own (slam/factors.py:residual_by_name, and
    linear/marginal.py:make_marginal_residual), else residual_by_name of
    the batch name."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    groups = tuple(groups)
    if qualname:
        if ".<locals>." in qualname:
            factory = qualname.split(".<locals>.")[0].split(".")[-1]
            if factory == "make_marginal_residual":
                return make_marginal_residual(groups)
            if factory in _FACTORY_NAMES:
                return F.residual_by_name(_FACTORY_NAMES[factory](groups))
        elif qualname.endswith("_residual"):
            try:
                return F.residual_by_name(qualname[:-len("_residual")])
            except ValueError:
                pass
    try:
        return F.residual_by_name(name)
    except ValueError:
        raise KeyError(
            f"residual of batch {name!r} (groups {groups}, function "
            f"{qualname!r}) is not known: call register_residual({name!r}, "
            f"fn) before loading") from None


# -- the archive -----------------------------------------------------------------

class _Writer:
    """Arrays of a header, each under a name of its own."""

    def __init__(self):
        self.arrays = {}

    def put(self, x):
        """A JSON-able form of x: tensors and arrays become {"a": name},
        tuples {"tuple": [...]}; dicts, lists and scalars as they are."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        if isinstance(x, np.ndarray):
            key = f"a{len(self.arrays)}"
            self.arrays[key] = x
            return {"a": key}
        if isinstance(x, tuple):
            return {"tuple": [self.put(v) for v in x]}
        if isinstance(x, list):
            return [self.put(v) for v in x]
        if isinstance(x, dict):
            return {"dict": [[k, self.put(v)] for k, v in x.items()]}
        if isinstance(x, (np.integer, np.floating, np.bool_)):
            return x.item()
        return x

    def save(self, path, kind, header):
        header = dict(header, format=FORMAT, kind=kind)
        with open(path, "wb") as f:
            np.savez(f, __header__=np.array(json.dumps(header)),
                     **self.arrays)


class _Reader:
    def __init__(self, data, convert):
        self.data = data
        self.convert = convert     # numpy array -> what the caller wants

    def get(self, x):
        if isinstance(x, dict):
            if "a" in x:
                return self.convert(self.data[x["a"]])
            if "tuple" in x:
                return tuple(self.get(v) for v in x["tuple"])
            return {k: self.get(v) for k, v in x["dict"]}
        if isinstance(x, list):
            return [self.get(v) for v in x]
        return x


def _load(path):
    """(header or None, arrays) of an .npz archive, without pickle."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    head = arrays.pop("__header__", None)
    return (None if head is None else json.loads(str(head))), arrays


def _tensor_fn(device, dtype):
    """numpy -> tensor on `device`; floating arrays in `dtype` (None: as
    stored), the rest as they are (indices as int64)."""
    def convert(a):
        if np.issubdtype(a.dtype, np.floating):
            return torch.tensor(a, device=device,
                                dtype=dtype or _torch_dtype(a.dtype))
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a, device=device, dtype=torch.int64)
        return torch.tensor(a, device=device)
    return convert


def _torch_dtype(np_dtype):
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(np_dtype)]


def _check(header, kind, path):
    if header.get("format") != FORMAT or header.get("kind") != kind:
        raise ValueError(f"{path} holds {header.get('kind')!r} of format "
                         f"{header.get('format')!r}, not {kind!r}")


# -- Values --------------------------------------------------------------------------

def save_values(path: str, values: Values):
    w = _Writer()
    w.save(path, "values", {"groups": w.put(dict(values.blocks))})


def load_values(path: str, *, device, dtype) -> Values:
    """Values from a file of `save_values`, or of the JAX package's
    `save_values` (an .npz of one array per group); `dtype` None keeps the
    stored float type."""
    header, arrays = _load(path)
    conv = _tensor_fn(device, dtype)
    if header is None:
        return Values({g: conv(a) for g, a in arrays.items()})
    _check(header, "values", path)
    return Values(_Reader(arrays, conv).get(header["groups"]))


# -- the LM carry ----------------------------------------------------------------------

def save_lm_carry(path: str, values: Values, lam, err):
    """Checkpoint the carry (values, lambda, error) of an `lm_run`.
    Restoring and continuing reproduces the uninterrupted run: the first
    iteration after the restore linearizes at the restored values, which is
    what the cached linearization of the carry held."""
    w = _Writer()
    w.save(path, "lm_carry", {
        "groups": w.put(dict(values.blocks)), "lam": float(lam),
        "err": float(err),
        "dtype": str(next(iter(values.blocks.values())).dtype)[6:]})


def load_lm_carry(path: str, *, device, dtype):
    """(values, lam, err) with lam and err 0-dim tensors on `device`, from a
    file of `save_lm_carry` or of the JAX package's."""
    header, arrays = _load(path)
    conv = _tensor_fn(device, dtype)
    if header is None:
        lam, err = arrays.pop("__lam__"), arrays.pop("__err__")
        values = Values({g: conv(a) for g, a in arrays.items()
                         if not g.startswith("__")})
        return values, conv(lam), conv(err)
    _check(header, "lm_carry", path)
    dt = dtype or _DTYPES[header["dtype"]]
    values = Values(_Reader(arrays, conv).get(header["groups"]))
    return (values, torch.tensor(header["lam"], dtype=dt, device=device),
            torch.tensor(header["err"], dtype=dt, device=device))


# -- factor graphs --------------------------------------------------------------------

def _qualname(fn):
    return getattr(fn, "__qualname__", None)


def save_graph(path: str, graph: FactorGraph):
    w = _Writer()
    batches = []
    for b in graph.batches:
        batches.append({
            "name": b.name, "groups": list(b.groups), "rdim": b.rdim,
            "residual": _qualname(b.residual_fn), "sign": b.sign,
            "idx": w.put(b.idx), "meas": w.put(dict(b.meas)),
            "noise": {"kind": b.noise.kind, "robust": b.noise.robust,
                      "data": w.put(b.noise.data), "k": w.put(b.noise.k)}})
    w.save(path, "graph", {"batches": batches})


def load_graph(path: str, *, device, dtype) -> FactorGraph:
    """A FactorGraph on `device` from a file of `save_graph`, or from the
    JAX package's (its .npz with the .json header beside it)."""
    header, arrays = _load(path)
    conv = _tensor_fn(device, dtype)
    if header is None:
        with open(path + ".json") as f:
            return _jax_graph(json.load(f), arrays, conv)
    _check(header, "graph", path)
    rd = _Reader(arrays, conv)
    out = []
    for h in header["batches"]:
        n = h["noise"]
        out.append(FactorBatch(
            h["name"], resolve_residual(h["name"], h["groups"],
                                        h["residual"]),
            tuple(h["groups"]), h["rdim"], rd.get(h["idx"]),
            rd.get(h["meas"]),
            NoiseModel(n["kind"], rd.get(n["data"]), n["robust"],
                       rd.get(n["k"])),
            sign=h["sign"]))
    return FactorGraph(out)


def _jax_graph(header, arrays, conv):
    """The batches of a JAX-written graph (utils/serialization.py:save_graph
    of the JAX package: arrays b{i}_idx, b{i}_meas_<key>, b{i}_noise,
    b{i}_noisek)."""
    out = []
    for i, h in enumerate(header):
        def arr(key):
            return conv(arrays[key]) if key in arrays else None
        out.append(FactorBatch(
            h["name"], resolve_residual(h["name"], h["groups"],
                                        h.get("residual_qualname")),
            tuple(h["groups"]), h["rdim"], arr(f"b{i}_idx"),
            {k: arr(f"b{i}_meas_{k}") for k in h["meas_keys"]},
            NoiseModel(h["noise"]["kind"], arr(f"b{i}_noise"),
                       h["noise"]["robust"], arr(f"b{i}_noisek")),
            sign=h.get("sign", 1.0)))
    return FactorGraph(out)


# -- ISAM2 ---------------------------------------------------------------------------------

def save_isam2(path: str, engine):
    """Snapshot a whole ISAM2 engine (nonlinear/isam2.py): its parameters,
    the host staging mirrors, the device state (theta, delta and, per
    factor type, the capacity tensors with the cached whitened rows J
    [cap, rdim, d] and r, and the needs-relinearization flags) and the
    preconditioner cache with its age, so that the resumed stream takes
    exactly the steps the uninterrupted one takes."""
    from gtsam_personal_tpu_torch.nonlinear.isam2 import ISAM2
    eng: ISAM2 = engine
    w = _Writer()
    params = dataclasses.asdict(eng.params)
    params["dtype"] = str(params["dtype"])[6:]
    hosts = []
    for key in eng._batch_keys:
        h = eng._hosts[key]
        hosts.append({
            "key": [key[0], list(key[1]), key[2], key[3], key[4]],
            "residual": _qualname(h["residual_fn"]),
            **{k: w.put(h[k]) for k in ("cap", "k", "idx", "meas",
                                        "noise_data", "noise_k",
                                        "pending")}})
    state = None
    st = eng._state
    if st is not None:
        state = {"theta": w.put(st.theta), "delta": w.put(st.delta),
                 "nvar": st.nvar,
                 "batches": [{
                     "key": [b.name, list(b.groups), b.rdim, b.noise_kind,
                             b.robust],
                     "residual": _qualname(b.residual_fn),
                     **{k: w.put(getattr(b, k))
                        for k in ("idx", "meas", "noise_data", "noise_k",
                                  "J", "r", "nfac", "needs_lin")}}
                     for b in st.batches]}
    w.save(path, "isam2", {
        "params": params, "theta_host": w.put(eng._theta_host),
        "nvar": eng._nvar, "cap_n": eng._cap_n,
        "pending_vars": eng._pending_vars, "hosts": hosts, "state": state,
        "rebuild": eng._rebuild, "free_vars": eng._free_vars,
        "pcache": w.put(eng._pcache),
        "updates_since_refresh": eng._updates_since_refresh})


def load_isam2(path: str, *, device):
    """The engine of a `save_isam2` file on `device`; its stream continues
    where the saved one stopped."""
    from gtsam_personal_tpu_torch.nonlinear.isam2 import (ISAM2, ISAM2Params,
                                                          _BatchState, _State)
    header, arrays = _load(path)
    _check(header, "isam2", path)
    params = dict(header["params"])
    params["dtype"] = _DTYPES[params["dtype"]]
    eng = ISAM2(ISAM2Params(**params), device=device)
    host = _Reader(arrays, lambda a: a.copy())
    dev = _Reader(arrays, lambda a: torch.tensor(a, device=eng.device))
    eng._theta_host = host.get(header["theta_host"])
    eng._nvar = dict(header["nvar"])
    eng._cap_n = dict(header["cap_n"])
    eng._pending_vars = {g: list(v) for g, v in header["pending_vars"].items()}
    eng._batch_keys, eng._hosts = [], {}
    for h in header["hosts"]:
        name, groups, rdim, kind, robust = h["key"]
        key = (name, tuple(groups), rdim, kind, robust)
        eng._batch_keys.append(key)
        eng._hosts[key] = dict(
            residual_fn=resolve_residual(name, groups, h["residual"]),
            **{k: host.get(h[k]) for k in ("cap", "k", "idx", "meas",
                                           "noise_data", "noise_k",
                                           "pending")})
    st = header["state"]
    if st is not None:
        batches = []
        for b in st["batches"]:
            name, groups, rdim, kind, robust = b["key"]
            batches.append(_BatchState(
                name, resolve_residual(name, groups, b["residual"]), groups,
                rdim, kind, robust, dev.get(b["idx"]), dev.get(b["meas"]),
                dev.get(b["noise_data"]), dev.get(b["noise_k"]),
                dev.get(b["J"]), dev.get(b["r"]), b["nfac"],
                dev.get(b["needs_lin"])))
        eng._state = _State(dev.get(st["theta"]), dev.get(st["delta"]),
                            dict(st["nvar"]), batches)
    eng._rebuild = header["rebuild"]
    eng._free_vars = {g: list(v) for g, v in header["free_vars"].items()}
    eng._pcache = dev.get(header["pcache"])
    eng._updates_since_refresh = header["updates_since_refresh"]
    return eng
