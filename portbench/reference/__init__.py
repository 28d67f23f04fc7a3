"""Plain PyTorch references, one module per kind of model, named by a
configuration's ``reference`` key.  They import nothing of the port."""
from __future__ import annotations

import importlib


def load(spec, w, **kw):
    """The reference of ``spec`` over the benchmark's weights ``w``."""
    mod = importlib.import_module(f"portbench.reference.{spec.reference}")
    return mod.Reference(spec, w, **kw)
