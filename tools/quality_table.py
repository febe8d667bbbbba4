"""Merge quality_run_full JSON logs into the two-arm comparison table.

Reads one or more run logs (each a stream of JSON lines from
tools/quality_run_full.py), collects the eval rows, and prints a markdown
table of matched-epoch metrics per (shape, seed) arm.

Usage: python tools/quality_table.py qr_*.log
"""

import json
import sys

METRICS = ["CD", "F", "depth_RMSE", "raydrop_acc", "PSNR", "SSIM"]


def load(paths):
    rows = {}
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "eval_epoch" in d:
                    arm = (d.get("shape", "?"), d.get("seed", 0))
                    rows.setdefault(arm, {})[d["eval_epoch"]] = d
    return rows


def main():
    rows = load(sys.argv[1:])
    if not rows:
        print("no eval rows found", file=sys.stderr)
        return
    epochs = sorted({e for r in rows.values() for e in r})
    arms = sorted(rows)
    print("| epoch | arm | " + " | ".join(METRICS) + " |")
    print("|" + "---|" * (len(METRICS) + 2))
    for ep in epochs:
        for arm in arms:
            d = rows[arm].get(ep)
            if not d:
                continue
            cells = " | ".join(str(d.get(m, "—")) for m in METRICS)
            print(f"| {ep} | {arm[0]} s{arm[1]} | {cells} |")


if __name__ == "__main__":
    main()
