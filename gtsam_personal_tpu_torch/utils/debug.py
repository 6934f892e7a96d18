"""Runtime-keyed debug tracing flags.

Reference parity: gtsam/base/debug.h (SURVEY.md §5.2): a global string-keyed
flag map consulted by `is_debug(key)` (ISDEBUG macro analogue); modules guard
verbose diagnostics behind it.

JAX counterpart: gtsam_personal_tpu/utils/debug.py (all of it; host
Python).
"""

from typing import Dict

_FLAGS: Dict[str, bool] = {}


def set_debug(key: str, enabled: bool = True):
    _FLAGS[key] = enabled


def is_debug(key: str) -> bool:
    return _FLAGS.get(key, False)


def clear_debug():
    _FLAGS.clear()


def debug_print(key: str, *args):
    """Print only when the flag is enabled."""
    if is_debug(key):
        print(f"[{key}]", *args)
