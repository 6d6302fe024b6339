"""Paired bootstrap significance test between two systems' label files (the
port's own copy of ``realise_tpu.eval.sig_test``).

Neubig-style paired bootstrap with the reference's exact resampling
semantics (reference: sig_test.py:15-52): shuffle the ids and take a 50%
subsample WITHOUT replacement, ``num_samples`` times; score both systems on
each subsample; report win ratios, the superior system's p-value proxy
(1 − win ratio, sig_test.py:43-47), and per-system mean / median / 95%
confidence intervals from the sorted subsample scores (sig_test.py:48-53).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from realise_tpu_torch.eval.metric_core import (
    LabelItem,
    metric_items,
    read_label_file,
)


def paired_bootstrap(
    sys1: Sequence[LabelItem],
    sys2: Sequence[LabelItem],
    targ: Sequence[LabelItem],
    metric_key: str = "sent-detect-f1",
    num_samples: int = 10000,
    sample_ratio: float = 0.5,
    seed: int = 0,
) -> Dict[str, float]:
    """Run the reference's subsampling scheme and return its statistics.

    Subsamples are drawn WITHOUT replacement (a shuffled-prefix of
    ``sample_ratio·n`` ids, reference: sig_test.py:24-27), which yields
    tighter score distributions than with-replacement bootstrap — the same
    inputs therefore reproduce the reference's printed numbers.
    """
    if not (len(sys1) == len(sys2) == len(targ)):
        raise ValueError("all three label lists must have equal length")
    n = len(targ)
    m = max(1, int(n * sample_ratio))
    rng = np.random.default_rng(seed)

    wins1 = wins2 = ties = 0
    scores1: List[float] = []
    scores2: List[float] = []
    for _ in range(num_samples):
        idx = rng.permutation(n)[:m]          # without replacement
        t = [targ[i] for i in idx]
        v1 = metric_items([sys1[i] for i in idx], t)[metric_key]
        v2 = metric_items([sys2[i] for i in idx], t)[metric_key]
        scores1.append(v1)
        scores2.append(v2)
        if v1 > v2:
            wins1 += 1
        elif v2 > v1:
            wins2 += 1
        else:
            ties += 1

    s1 = np.sort(np.asarray(scores1))
    s2 = np.sort(np.asarray(scores2))
    lo_i = int(num_samples * 0.025)
    hi_i = min(int(num_samples * 0.975), num_samples - 1)
    w1, w2 = wins1 / num_samples, wins2 / num_samples
    return {
        "wins_sys1": w1,
        "wins_sys2": w2,
        "ties": ties / num_samples,
        # p-value proxy for the superior system (reference: sig_test.py:43-47).
        "p_value": 1.0 - max(w1, w2),
        "sys1_mean": float(s1.mean()),
        "sys1_median": float(np.median(s1)),
        "sys1_ci95_low": float(s1[lo_i]),
        "sys1_ci95_high": float(s1[hi_i]),
        "sys2_mean": float(s2.mean()),
        "sys2_median": float(np.median(s2)),
        "sys2_ci95_low": float(s2[lo_i]),
        "sys2_ci95_high": float(s2[hi_i]),
    }


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sys1", required=True, help="label file of system 1")
    parser.add_argument("--sys2", required=True, help="label file of system 2")
    parser.add_argument("--target", required=True, help="gold label file")
    parser.add_argument("--metric", default="sent-detect-f1")
    parser.add_argument("--num_samples", type=int, default=10000)
    parser.add_argument("--sample_ratio", type=float, default=0.5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    res = paired_bootstrap(
        read_label_file(args.sys1),
        read_label_file(args.sys2),
        read_label_file(args.target),
        metric_key=args.metric,
        num_samples=args.num_samples,
        sample_ratio=args.sample_ratio,
        seed=args.seed,
    )
    print("Win ratio: sys1=%.3f, sys2=%.3f, tie=%.3f"
          % (res["wins_sys1"], res["wins_sys2"], res["ties"]))
    if res["wins_sys1"] > res["wins_sys2"]:
        print("(sys1 is superior with p value p=%.3f)" % res["p_value"])
    elif res["wins_sys2"] > res["wins_sys1"]:
        print("(sys2 is superior with p value p=%.3f)" % res["p_value"])
    for name in ("sys1", "sys2"):
        print("%s mean=%.3f, median=%.3f, 95%% confidence interval=[%.3f, %.3f]"
              % (name, res[f"{name}_mean"], res[f"{name}_median"],
                 res[f"{name}_ci95_low"], res[f"{name}_ci95_high"]))


if __name__ == "__main__":
    main()
