"""Spans around the port's functions, from the benchmark's side, for the
traced window only.

Every function of the port (``wayne_tpu_torch``) reachable as a module
attribute or a class attribute is replaced, in every module and class that
holds it, by a wrapper that opens a ``torch.profiler.record_function``
span named ``port:<path>:<function>`` (``port:ops/exposure.py:
simulate_exposure``) around the call. The profiler records the spans as
user annotations on their threads, so each operator that launched a
kernel lies inside the spans of the port's functions that were running:
the innermost names its layer. Closures and lambdas inside a function
count as that function. ``restore`` puts every original back.
"""

from __future__ import annotations

import functools
import os
import sys
import types

PACKAGE = "wayne_tpu_torch"
PREFIX = "port:"


def _label(fn) -> str:
    path = fn.__code__.co_filename.replace(os.sep, "/")
    i = path.rfind(PACKAGE + "/")
    return f"{PREFIX}{path[i + len(PACKAGE) + 1:]}:{fn.__name__}"


def _ours(obj) -> bool:
    return (isinstance(obj, types.FunctionType)
            and (obj.__module__ or "").split(".", 1)[0] == PACKAGE)


class Spans:
    """The installed wrappers; ``restore`` undoes them."""

    def __init__(self):
        import torch

        self._record = torch.profiler.record_function
        self._wrappers: dict = {}          # original -> wrapper
        self._undo: list = []              # (holder, name, original)
        for mod in [m for n, m in list(sys.modules.items())
                    if n.split(".", 1)[0] == PACKAGE and m is not None]:
            self._patch(mod, vars(mod))
            for obj in list(vars(mod).values()):
                if (isinstance(obj, type) and obj.__module__ == mod.__name__
                        and not _is_autograd_function(obj)):
                    self._patch(obj, obj.__dict__)

    def _wrap(self, fn):
        if fn not in self._wrappers:
            label, record = _label(fn), self._record

            @functools.wraps(fn)
            def spanned(*args, **kw):
                with record(label):
                    return fn(*args, **kw)

            self._wrappers[fn] = spanned
        return self._wrappers[fn]

    def _patch(self, holder, namespace) -> None:
        for name, obj in list(namespace.items()):
            if _ours(obj) and not name.startswith("__"):
                self._undo.append((holder, name, obj))
                setattr(holder, name, self._wrap(obj))

    def restore(self) -> None:
        for holder, name, original in reversed(self._undo):
            setattr(holder, name, original)
        self._undo.clear()


def _is_autograd_function(cls) -> bool:
    import torch

    return issubclass(cls, torch.autograd.Function)
