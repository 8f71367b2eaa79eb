"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's steps from the same seed.  The
program takes them twice on the same draws: one captured replay at a time
(the state after each step is read), and as the first steps of a chunk of
the window's own captured call, which carries the state between replays
(only its ELBOs can be read).

Three numbers; a cell holds those that its ``workloads/<cell>.json`` names
to their limits:

* ``elbo_gap`` -- the largest relative gap of a step's ELBO, over the
  checked steps of both takes: ``|program - reference| / |reference|``.
* ``first_gap`` -- the first step's move, by the worst leaf: VI's first
  gradient as Adam holds it, QEM's first change of Q's parameters.  A
  leaf's gap is ``| |program| - |reference| |`` (norms, not the norm of
  the difference) over the larger of the reference's norm of that leaf and
  of the median leaf.
* ``change_gap`` -- the change of the parameters over the checked steps,
  by the worst leaf in the same way, leaving out leaves whose reference
  first move is under a thousandth of the median leaf's (they move by
  round-off alone).
"""
from __future__ import annotations

import math
import statistics

NAMES = ("elbo_gap", "first_gap", "change_gap")
#: a leaf whose reference first move is under this share of the median
#: leaf's takes no part in ``change_gap``
MOVED = 1e-3


def _norm(t):
    return float(t.double().norm())


def leaf_gaps(prog, ref):
    """``{leaf: gap}`` by the norm rule, over the reference's leaves."""
    norms = {k: _norm(v) for k, v in ref.items()}
    median = statistics.median(norms.values())
    out = {}
    for k in ref:
        p = _norm(prog[k])
        denom = max(norms[k], median)
        out[k] = abs(p - norms[k]) / denom if denom > 0 and math.isfinite(p) else math.inf
    return out


def first_moves(leaves, first):
    """The first gradient where the method keeps one, else the first
    change of the parameters."""
    if first is not None:
        return first
    return {k: leaves[1][k] - leaves[0][k] for k in leaves[0]}


def compare(program, reference, leaves=None, carried=None):
    """``({name: number}, {name: worst leaf})`` of the program's
    ``(elbos, leaves, first)`` against the reference's; ``carried``, the
    ELBOs of the window's own call over the same steps, is held to
    ``elbo_gap`` too; ``leaves``, a dict, receives every leaf's gaps."""
    p_elbos, p_leaves, p_first = program
    r_elbos, r_leaves, r_first = reference
    gaps = {}
    for take, elbos in (("step", p_elbos), ("carried step", carried or [])):
        for i, (p, r) in enumerate(zip(elbos, r_elbos)):
            gaps[f"{take} {i + 1}"] = abs(p - r) / abs(r) if math.isfinite(p) else math.inf
    worst = max(gaps, key=gaps.get)
    numbers, where = {"elbo_gap": gaps[worst]}, {"elbo_gap": worst}

    p_first, r_first = first_moves(p_leaves, p_first), first_moves(r_leaves, r_first)
    first = leaf_gaps(p_first, r_first)
    worst = max(first, key=first.get)
    numbers["first_gap"], where["first_gap"] = first[worst], worst

    median = statistics.median(_norm(v) for v in r_first.values())
    moved = [k for k, v in r_first.items() if _norm(v) >= MOVED * median]
    p_change = {k: p_leaves[-1][k] - p_leaves[0][k] for k in moved}
    r_change = {k: r_leaves[-1][k] - r_leaves[0][k] for k in moved}
    change = leaf_gaps(p_change, r_change)
    worst = max(change, key=change.get)
    numbers["change_gap"], where["change_gap"] = change[worst], worst
    if leaves is not None:
        leaves.update({"first": first, "change": change})
    return numbers, where


def judge(numbers, limits):
    """``(correct, {name: {"value", "limit"}})``: every number that the
    cell's limits name at or under its limit (a cell compares the numbers
    its limits name, at least one)."""
    table = {}
    for name in NAMES:
        if name in limits:
            table[name] = {"value": numbers.get(name, math.inf), "limit": limits[name]}
    ok = bool(table) and all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
