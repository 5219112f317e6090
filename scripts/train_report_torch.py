"""Summarize a training-run log of the PyTorch port (the port's own copy of
scripts/train_report.py, with the same output and ``parse(path)``).

Parses the trainer's per-interval lines (``it N  loss L  gnorm G  Ss``,
aid_tpu_torch/training/trainer.py) out of a run log and emits:
  * a markdown table at a decimated cadence (stdout),
  * aggregate wall-clock / step-time stats incl. checkpoint-save cost,
  * optionally a loss-curve png next to the log (matplotlib, if present).

A diverged interval (``loss nan``, ``loss inf``, ``loss -inf``) is kept as a
row with that float: those are the rows a reader of a failed run needs.

Usage: python scripts/train_report_torch.py <train_log> [table_every_its]
"""
import os
import re
import sys


def parse(path):
    rows = []  # (it, loss, gnorm, interval_s, skip_pct)
    events = []
    # the optional "skip NN%" field appears exactly when the guardrail fired
    # during the interval; those lines must not be dropped. A diverged
    # interval prints "loss nan" or "loss inf" (the trainer's {:.5f}), and
    # the loss field takes them, so those rows are kept too
    pat = re.compile(
        r"^it (\d+)\s+loss ([-+]?(?:nan|inf|[\d.]+(?:[eE][-+]?\d+)?))"
        r"\s+gnorm ([\d.naife+]+)"
        r"(?:\s+skip (\d+)%)?(?:\s+top \S+)?\s+([\d.]+)s")
    with open(path) as f:
        for line in f:
            m = pat.match(line.strip())
            if m:
                rows.append((int(m.group(1)), float(m.group(2)),
                             m.group(3), float(m.group(5)),
                             int(m.group(4) or 0)))
            elif "checkpoint" in line or "watchdog" in line \
                    or "heavy_logging" in line:
                events.append(line.strip())
    return rows, events


def main():
    log = sys.argv[1]
    every = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    rows, events = parse(log)
    if not rows:
        print("no training lines found")
        return
    log_int = rows[-1][0] - rows[-2][0] if len(rows) > 1 else rows[0][0]
    # steady-state step time: median interval (checkpoint/heavy intervals
    # inflate the mean)
    ivals = sorted(r[3] for r in rows)
    med = ivals[len(ivals) // 2]
    tot = sum(r[3] for r in rows)
    print(f"{len(rows)} intervals x {log_int} its; "
          f"median {med / log_int * 1e3:.0f} ms/step; "
          f"total logged wall {tot / 3600:.2f} h "
          f"(overhead vs median-step: {tot - med * len(rows):.0f}s)")
    print("\n| it | loss | gnorm | skip % | interval s |")
    print("|---|---|---|---|---|")
    for it, loss, gn, s, skip in rows:
        if it % every == 0 or it == rows[-1][0]:
            print(f"| {it} | {loss:.4f} | {gn} | {skip} | {s:.1f} |")
    for e in events:
        print("  #", e)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        its = [r[0] for r in rows]
        ls = [r[1] for r in rows]
        fig, ax = plt.subplots(figsize=(7, 3.2))
        ax.plot(its, ls, lw=0.8)
        # running mean over ~10 intervals for the trend
        k = max(1, min(10, len(ls) // 10))
        rm = [sum(ls[max(0, i - k + 1):i + 1])
              / len(ls[max(0, i - k + 1):i + 1]) for i in range(len(ls))]
        ax.plot(its, rm, lw=1.8)
        ax.set_xlabel("iteration")
        ax.set_ylabel("loss")
        ax.set_yscale("log")
        ax.grid(alpha=0.3)
        out = os.path.join(os.path.dirname(os.path.abspath(log)),
                           "train_loss_curve.png")
        fig.tight_layout()
        fig.savefig(out, dpi=120)
        print(f"\nloss curve -> {out}")
    except Exception as e:  # matplotlib optional
        print(f"(no png: {e})")


if __name__ == "__main__":
    main()
