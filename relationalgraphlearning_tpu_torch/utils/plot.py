"""Training curves (port of ``relationalgraphlearning_tpu/utils/plot.py``).

The curves come from the ``metrics.jsonl`` the train loop writes; a regex
over ``output.log`` keeps the reference's workflow for plain logs.

    python -m relationalgraphlearning_tpu_torch.utils.plot data/output \
        [out.png]
"""

from __future__ import annotations

import json
import os
import re
import sys
from collections import defaultdict


def load_jsonl(path: str):
    """{metric: (steps, values)} of every record of ``metrics.jsonl``."""
    series = defaultdict(lambda: ([], []))
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            step = rec.get("step", 0)
            for k, v in rec.items():
                if k in ("step", "time"):
                    continue
                series[k][0].append(step)
                series[k][1].append(v)
    return series


_LOG_RE = re.compile(
    r"val success (?P<sr>[\d.]+) coll (?P<cr>[\d.]+) nav (?P<nt>[\d.]+)")


def load_log(path: str):
    """The validation curves parsed from ``output.log``."""
    series = defaultdict(lambda: ([], []))
    step = 0
    with open(path) as f:
        for line in f:
            m = _LOG_RE.search(line)
            if m:
                step += 1
                series["val/success_rate"][0].append(step)
                series["val/success_rate"][1].append(float(m.group("sr")))
                series["val/collision_rate"][0].append(step)
                series["val/collision_rate"][1].append(float(m.group("cr")))
    return series


def main(argv=None) -> str:
    """Plot a run's curves into one PNG (``<run_dir>/curves.png`` by
    default) -> its path."""
    argv = argv or sys.argv[1:]
    run_dir = argv[0] if argv else "data/output"
    out = argv[1] if len(argv) > 1 else os.path.join(run_dir, "curves.png")
    jsonl = os.path.join(run_dir, "metrics.jsonl")
    series = load_jsonl(jsonl) if os.path.exists(jsonl) else load_log(
        os.path.join(run_dir, "output.log"))

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = [k for k in series if not k.startswith("il/")]
    n = max(len(keys), 1)
    cols = min(n, 3)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3.5 * rows),
                             squeeze=False)
    for ax, k in zip(axes.flat, sorted(keys)):
        xs, ys = series[k]
        ax.plot(xs, ys)
        ax.set_title(k)
        ax.set_xlabel("episodes")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
