"""The numbers a training cell's check compares, from the first steps of
the program and of the reference: the largest relative gap of the steps'
losses, and the largest gap of the norms of the first gradient and of the
change after the last step, leaf by leaf, each against the larger of the
reference's norm of that leaf and of the median leaf. A leaf whose
reference gradient is under a thousandth of the median leaf's moves by
round-off alone under Adam, and is left out of the change's comparison.
"""

from __future__ import annotations

import statistics


def norms(leaves: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The largest |prog - ref| / max(ref, median of ref) over ``keep``
    (every leaf when None)."""
    floor = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor)
               for k in (ref if keep is None else keep))


def gaps(prog: dict, want: dict) -> dict:
    floor = statistics.median(want["grad_norms"].values())
    moved = [k for k, v in want["grad_norms"].items() if v >= 1e-3 * floor]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(prog["losses"], want["losses"])),
            "grad_gap": leaf_gap(prog["grad_norms"], want["grad_norms"]),
            "change_gap": leaf_gap(prog["change_norms"],
                                   want["change_norms"], moved)}


def compare(run, prog, want) -> bool:
    """Record and judge the numbers that the traffic gives a limit (a
    number that no control or fault separates from sound runs has none,
    and is not compared)."""
    limits = run.traffic["limits"]
    return all([run.compare(k, v, limits[k])
                for k, v in gaps(prog, want).items() if k in limits])
