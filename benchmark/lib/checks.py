"""The numbers that decide ``correct``; a cell's limits file names those it
compares, each with its limit.

Training (the system's first steps against the reference's, from the same
weights on the same crops and draws):

- ``loss_gap``: the widest relative gap of a step's loss;
- ``grad_gap``: by the worst parameter, the gap between the norms of the
  first gradient as Adam gets it (before its decay term), over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
- ``grad_gap_median``: the median parameter's gap, steady from seed to seed
  where the worst parameter's is not;
- ``change_gap``: as ``grad_gap``, for each leaf's change over the steps,
  BatchNorm's running statistics counted as leaves.

The gaps leave out the parameters whose reference gradient is under a
thousandth of the median parameter's: their gradient is nought to rounding
(a convolution's bias before a BatchNorm, whose mean it removes), so the
system's is noise and Adam moves them by round-off alone.

Serving (the answers, class maps, judged by what they say): by how much
the reference's blended logit of each served class lies below its best,
over the reference logits' standard deviation, at every pixel of the
sampled requests:

- ``class_gap_mean``: the mean of that gap over the pixels;
- ``class_gap``: its widest, for the record (it swings from seed to seed by
  its nature, and bf16's widest reads within 2x of the int8 control's).
"""

from __future__ import annotations

import statistics

UNREACHED = 1e-3  # under this share of the median parameter's reference gradient, a parameter's is nought


def reached_leaves(ref: dict) -> set[str]:
    """Every leaf but the parameters the loss does not reach beyond rounding."""
    grads = ref["grad_norms"]
    floor = UNREACHED * statistics.median(grads.values())
    return {n for n in ref["change_norms"] if grads.get(n, floor) >= floor}


def leaf_gaps(ours: dict, ref: dict, key: str) -> list[tuple[float, str]]:
    """(gap, leaf) of every reached leaf of ``key``, the widest first: the
    gap between the two norms over the reference's norm of the leaf or of
    the median leaf, whichever is larger; a leaf missing on our side reads 1."""
    reached = reached_leaves(ref)
    names = [k for k in ref[key] if k in reached]
    floor = statistics.median(ref[key][k] for k in names)
    return sorted(((abs(ours[key].get(k, 0.0) - ref[key][k]) / max(ref[key][k], floor, 1e-30), k) for k in names),
                  reverse=True)


def training_numbers(ours: dict, ref: dict) -> dict[str, float]:
    """The training numbers of ``ours`` against ``ref`` (both as
    :func:`benchmark.reference.training.follow` reads them)."""
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(ours["losses"], ref["losses"])]
    if len(ours["losses"]) != len(ref["losses"]):
        losses.append(1.0)
    grads = leaf_gaps(ours, ref, "grad_norms")
    return {
        "loss_gap": max(losses),
        "grad_gap": grads[0][0],
        "grad_gap_median": statistics.median(g for g, _ in grads),
        "change_gap": leaf_gaps(ours, ref, "change_norms")[0][0],
    }


def within(numbers: dict[str, float], limits: dict) -> dict[str, dict]:
    """Each number beside its limit, for the result line; a number that is
    not finite is over any limit."""
    out = {}
    for name, lim in limits["limits"].items():
        value = numbers.get(name, float("inf"))
        out[name] = {"value": value, "limit": lim}
    return out


def all_within(checks: dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
