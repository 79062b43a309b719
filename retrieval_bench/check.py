"""The comparisons that decide ``correct``: each number a run compares,
worked out from what the timed path produced and what the reference says,
and its judgment against the cell's limits (``limits/<cell>.json``).

Every number is a worst case over the run's sample, scaled by the
reference's own largest value, so it reads alike at any width:

* ``tokens_mismatch``: texts whose token ids at the encoder's input differ
  from the text's words (exact: limit 0).
* ``rep_weight_err``: the widest gap between a handed-off term's weight and
  the reference rep's weight of that term.
* ``rep_rank_gap``: how far below the reference's T-th largest weight a
  handed-off term lies (0 when the program kept the reference's top T, up
  to ties).
* ``engine_score_err``: the widest gap between a returned score and the
  reference's score of that doc.
* ``engine_rank_gap``: how far below the reference's k-th score a returned
  doc lies; 1 for a list shorter than the reference's matched docs.
"""

from __future__ import annotations

import json
import os

import numpy as np


def token_mismatches(rows: list, token_lists: list) -> int:
    """rows: the (ids, mask) rows the encoder got; token_lists: the texts'
    words as the reference reads them."""
    bad = 0
    for (ids, mask), toks in zip(rows, token_lists):
        if list(np.asarray(ids)[np.asarray(mask) > 0]) != list(toks):
            bad += 1
    return bad


def rep_numbers(terms: np.ndarray, vals: np.ndarray,
                ref: np.ndarray) -> dict:
    """terms, vals [n, T]: the handed-off reps; ref [n, V] float32."""
    t = terms.shape[1]
    err = gap = 0.0
    for i in range(len(terms)):
        r = ref[i]
        top = float(r.max())
        if top <= 0:
            continue
        keep = vals[i] > 0
        at = r[terms[i][keep]]
        err = max(err, float(np.abs(vals[i][keep] - at).max(initial=0.0))
                  / top)
        want = min(t, int((r > 0).sum()))
        if keep.sum() < want:
            gap = 1.0
            continue
        kth = float(np.partition(r, r.size - t)[r.size - t])
        gap = max(gap, (kth - float(at.min(initial=kth))) / top)
    return {"rep_weight_err": err, "rep_rank_gap": max(gap, 0.0)}


def engine_numbers(served: list, refs: list, k: int) -> dict:
    """served: (doc ids, scores) a query's timed call returned; refs: the
    reference's ``score_queries`` entries of the same queries."""
    err = gap = 0.0
    for (ids, scores), ref in zip(served, refs):
        top = float(ref["top_scores"][0])
        if top <= 0:
            continue
        want = min(k, ref["n_positive"])
        if len(ids) < want:
            gap = 1.0
        if len(ids) == 0:
            continue
        at = np.asarray(ref["at"], np.float64)
        s = np.asarray(scores, np.float64)
        err = max(err, float(np.abs(s - at).max()) / top)
        kth = float(ref["top_scores"][want - 1])
        gap = max(gap, (kth - float(at.min())) / top)
    return {"engine_score_err": err, "engine_rank_gap": max(gap, 0.0)}


def limits(root: str, cell: str) -> dict:
    with open(os.path.join(root, "retrieval_bench", "limits",
                           f"{cell}.json")) as f:
        return json.load(f)["limits"]


def judge(numbers: dict, lim: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit fails."""
    out, ok = {}, True
    for name, v in numbers.items():
        cap = lim.get(name)
        out[name] = {"value": v, "limit": cap}
        if cap is None or not (v <= cap):
            ok = False
    return ok, out


def _worst_leaf(prog: dict, ref: dict, leaves) -> float:
    """The widest gap between the program's and the reference's norm of a
    leaf, over the larger of the reference's norm of that leaf and of the
    median leaf."""
    med = float(np.median([ref[k] for k in leaves]))
    return max((abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves),
               default=0.0)


def train_numbers(losses: list, grad1: dict, change: dict,
                  ref: dict) -> dict:
    """A training step against the reference's steps from the same start:
    ``loss_gap``, the widest relative gap of a step's loss;
    ``grad_gap``, of the first gradient's norm by leaf (as the optimizer
    got it, clipped); ``change_gap``, of the factors' change after the
    steps by leaf. The change leaves out leaves whose reference gradient
    stays under a thousandth of the median leaf's at every step: those
    move under Adam by round-off alone."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"]))
    g_ref = ref["grad_norms"]
    top = {k: max(s[k] for s in g_ref) for k in g_ref[0]}
    med = float(np.median(list(top.values())))
    moved = [k for k in top if top[k] >= 1e-3 * med]
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(grad1, g_ref[0], list(g_ref[0])),
            "change_gap": _worst_leaf(change, ref["change_norms"], moved)}
