"""Key machinery: Symbol / LabeledSymbol / EdgeKey (reference:
gtsam/inference/Key.h, Symbol.h, LabeledSymbol.h, EdgeKey.h).

JAX counterpart: gtsam_personal_tpu/core/keys.py (all of it). Host Python;
a copy of the JAX module, which imports nothing of JAX either.

The framework addresses variables as (group, index) pairs —
`Values` blocks are dense per-group arrays. This module provides the
reference's 64-bit key encodings for interop (reading keyed files, printing,
porting user code) and a bridge to (group, index) addressing:

- `Symbol('x', 5)` packs char+index exactly like the reference
  (char in the top 8 bits, Symbol.h): users of `gtsam.Symbol` /
  `symbol_shorthand.X(5)` find the same API.
- `symbol_shorthand.X(...)` etc. mirror python/gtsam/symbol_shorthand.
- `SymbolTable` maps symbols <-> (group, index) for graph building.
"""

from typing import Dict, Tuple


_CHR_BITS = 8
_IDX_BITS = 56
_IDX_MASK = (1 << _IDX_BITS) - 1


class Symbol:
    """Char + 56-bit index key (reference: inference/Symbol.h)."""

    __slots__ = ("chr", "index")

    def __init__(self, c, index: int = 0):
        if isinstance(c, str):
            self.chr = c
            self.index = int(index)
        else:  # decode from a packed key
            key = int(c)
            self.chr = chr(key >> _IDX_BITS)
            self.index = key & _IDX_MASK

    def key(self) -> int:
        return (ord(self.chr) << _IDX_BITS) | self.index

    def __int__(self):
        return self.key()

    def __eq__(self, other):
        return isinstance(other, Symbol) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return f"{self.chr}{self.index}"

    def string(self) -> str:
        return repr(self)


class LabeledSymbol:
    """Char + label char + 48-bit index (reference: inference/LabeledSymbol.h,
    used for multi-robot problems: X(robot, index))."""

    __slots__ = ("chr", "label", "index")
    _LIDX_BITS = 48
    _LIDX_MASK = (1 << 48) - 1

    def __init__(self, c, label=None, index: int = 0):
        if isinstance(c, str):
            self.chr = c
            self.label = label
            self.index = int(index)
        else:
            key = int(c)
            self.chr = chr((key >> 56) & 0xFF)
            self.label = chr((key >> 48) & 0xFF)
            self.index = key & self._LIDX_MASK

    def key(self) -> int:
        return ((ord(self.chr) << 56) | (ord(self.label) << 48)
                | self.index)

    def __int__(self):
        return self.key()

    def __eq__(self, other):
        return isinstance(other, LabeledSymbol) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return f"{self.chr}{self.label}{self.index}"


class EdgeKey:
    """Two 32-bit indices packed into one key (reference: inference/EdgeKey.h)."""

    __slots__ = ("i", "j")

    def __init__(self, i, j=None):
        if j is None:
            key = int(i)
            self.i = key >> 32
            self.j = key & 0xFFFFFFFF
        else:
            self.i, self.j = int(i), int(j)

    def key(self) -> int:
        # mask both fields to uint32 like the reference's truncation, so
        # out-of-range i/j can never bleed across the 32-bit field boundary
        return ((self.i & 0xFFFFFFFF) << 32) | (self.j & 0xFFFFFFFF)

    def __int__(self):
        return self.key()

    def __repr__(self):
        return f"{{{self.i}, {self.j}}}"


class _Shorthand:
    def __init__(self, c):
        self._c = c

    def __call__(self, j: int) -> Symbol:
        return Symbol(self._c, j)


class symbol_shorthand:
    """Mirrors python/gtsam/symbol_shorthand.py: X(5) == Symbol('x', 5)."""


for _c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ":
    setattr(symbol_shorthand, _c, _Shorthand(_c.lower()))


class SymbolTable:
    """Bridge between Symbol keys and this framework's (group, index)
    addressing: assign each symbol chr to a manifold group and hand out dense
    indices in insertion order."""

    def __init__(self, group_of_chr: Dict[str, str]):
        self.group_of_chr = dict(group_of_chr)
        self._fwd: Dict[int, Tuple[str, int]] = {}
        self._next: Dict[str, int] = {}

    def resolve(self, sym) -> Tuple[str, int]:
        """Symbol -> (group, dense index), allocating on first sight."""
        key = int(sym)
        if key not in self._fwd:
            c = Symbol(key).chr
            g = self.group_of_chr[c]
            i = self._next.get(g, 0)
            self._next[g] = i + 1
            self._fwd[key] = (g, i)
        return self._fwd[key]

    def counts(self) -> Dict[str, int]:
        return dict(self._next)
