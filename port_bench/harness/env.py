"""Process environment of a run: fixed cache directories inside the
checkout, and the isolation check.

``prepare`` runs before torch is imported. Every cache the program or a
compiler may write goes to a fixed directory under ``<checkout>/build``
(the port builds its kernel library in ``build/kernels`` by itself;
``run.py`` puts Python's bytecode in ``build/pycache``), so the second
run of a cell in a checkout finds what the first one built.
"""

from __future__ import annotations

import os
import sys

# Top-level module names that no process of the benchmark may load: the
# JAX package the port was made from, and JAX with its libraries. Names
# are compared whole (the part before the first dot), since the port's
# own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multiview_inpaint_tpu")


def prepare(root: str) -> None:
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    # Libraries that load JAX by themselves where they find it.
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))
