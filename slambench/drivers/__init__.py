"""Drivers: how a configuration's program is set up and called, one module
per driver, named by the configuration's ``driver`` key.  A driver builds
its inputs from the seed and the traffic mix, warms up the program in its
constructor (set-up) and makes one timed call per ``step_call``."""
from __future__ import annotations

import functools


class LogExhausted(RuntimeError):
    """The traffic log ran out before the window closed: the run fails
    rather than end the window early."""


def wrap_method(obj, name: str, spans, span_name: str):
    """Replace ``obj.name`` on the instance by a call of it inside the host
    span ``span_name``; the original stays as ``__wrapped__``."""
    fn = getattr(obj, name)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with spans.span(span_name):
            return fn(*args, **kwargs)

    setattr(obj, name, wrapped)
    return fn
