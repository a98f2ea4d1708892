"""Results that set-up or a reader works out from the benchmark's own
files alone (a network's weight list, its FLOP count), kept as JSON in
``<checkout>/build/port_bench`` under a key of their inputs, so that only
the first run in a checkout pays for them."""

from __future__ import annotations

import hashlib
import json
import os

DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "port_bench")


def sources_key(folder: str) -> str:
    """A digest of the Python sources under ``folder``."""
    h = hashlib.sha256()
    for base, dirs, files in sorted(os.walk(folder)):
        dirs.sort()
        for name in sorted(files):
            if name.endswith(".py"):
                with open(os.path.join(base, name), "rb") as f:
                    h.update(name.encode() + f.read())
    return h.hexdigest()


def memo(name: str, key, compute):
    """``compute()``'s JSON value, from the file of ``name`` and ``key``
    (any JSON value) when a run in this checkout has written it."""
    digest = hashlib.sha256(json.dumps(key, sort_keys=True)
                            .encode()).hexdigest()[:24]
    path = os.path.join(DIR, f"{name}-{digest}.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        pass
    value = compute()
    os.makedirs(DIR, exist_ok=True)
    tmp = f"{path}.part"
    with open(tmp, "w") as f:
        json.dump(value, f)
    os.replace(tmp, path)
    return value
