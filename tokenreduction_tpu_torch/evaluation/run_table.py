"""Run-overview table (reference get_wandb_tables.py).

Two sources:
- `--wandb_project`: dump from the W&B API exactly like the reference
  (needs network + login)
- `--scan_root`: offline mode -- walk a directory of training output dirs
  and build the same CSV from checkpoint meta.json files (the analysis
  suite only needs Name/max_accuracy/keep_rate/reduction_loc/
  heuristic_pattern/model/output_dir/Tags columns (capital
  Tags: reference get_wandb_tables.py:61 — compare_merging_capacity.py
  filters on it),
  reference get_wandb_tables.py:21-69).

The port's copy of ``tokenreduction_tpu/evaluation/run_table.py``: below this
docstring the two files are equal, apart from the package name in
imports (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import argparse
import json
import os

import pandas as pd

COLUMNS = ["Name", "max_accuracy", "keep_rate", "reduction_loc",
           "heuristic_pattern", "model", "output_dir", "Tags"]
# API mode carries the reference's extra bookkeeping columns
# (get_wandb_tables.py:48-60: epoch/epochs and the creation timestamp
# the table is sorted by); consumers address columns by name, so the
# superset is compatible with the scan-mode CSV.
WANDB_COLUMNS = COLUMNS[:2] + ["epoch", "epochs"] + COLUMNS[2:] + ["Created"]


def scan_output_dirs(root: str) -> pd.DataFrame:
    rows = []
    for dirpath, dirnames, filenames in os.walk(root):
        if "meta.json" not in filenames:
            continue
        if os.path.basename(dirpath) not in ("best_checkpoint",):
            continue
        with open(os.path.join(dirpath, "meta.json")) as f:
            meta = json.load(f)
        run_args = meta.get("run_args") or {}
        cfg = meta.get("model_cfg") or {}
        out_dir = os.path.dirname(dirpath)
        rows.append({
            "Name": os.path.basename(out_dir),
            "max_accuracy": meta.get("max_accuracy", 0.0),
            "keep_rate": list(cfg.get("keep_rate") or []),
            "reduction_loc": list(cfg.get("reduction_loc") or []),
            "heuristic_pattern": run_args.get("heuristic_pattern", ""),
            "model": run_args.get("model", cfg.get("method", "")),
            "output_dir": out_dir,
            "Tags": run_args.get("wandb_group", ""),
        })
    return pd.DataFrame(rows, columns=COLUMNS)


def from_wandb(project: str, entity: str = "") -> pd.DataFrame:
    """W&B API dump with the reference's row rules
    (get_wandb_tables.py:28-66): skip runs tagged 'Not Best' or
    'hidden', runs still in state 'running', and runs whose summary has
    no max_accuracy; heuristic_pattern defaults to ''; epoch defaults to
    0; rows sorted by creation time."""
    import wandb

    api = wandb.Api()
    path = f"{entity}/{project}" if entity else project
    rows = []
    for run in api.runs(path):
        if "Not Best" in run.tags or "hidden" in run.tags:
            continue
        if run.state == "running":
            continue
        summary = run.summary
        if "max_accuracy" not in summary:
            continue
        cfg = run.config
        rows.append({
            "Name": run.name,
            "max_accuracy": summary["max_accuracy"],
            "epoch": summary.get("epoch", 0),
            "epochs": cfg.get("epochs", 0),
            "keep_rate": cfg.get("keep_rate", []),
            "reduction_loc": cfg.get("reduction_loc", []),
            "heuristic_pattern": cfg.get("heuristic_pattern", ""),
            "model": cfg.get("model", ""),
            "output_dir": cfg.get("output_dir", ""),
            "Tags": ",".join(run.tags),
            "Created": run.created_at,
        })
    df = pd.DataFrame(rows, columns=WANDB_COLUMNS)
    if len(df):
        df = df.sort_values(by=["Created"], ignore_index=True)
    return df


def main(argv=None):
    p = argparse.ArgumentParser("run overview table")
    # reference flag names (get_wandb_tables.py:10-12) kept as aliases
    p.add_argument("--scan_root", default="")
    p.add_argument("--wandb_project", "--project", dest="wandb_project",
                   default="")
    p.add_argument("--wandb_entity", "--entity", dest="wandb_entity",
                   default="")
    p.add_argument("--output", "--output_path", dest="output",
                   default="run_overview.csv")
    args = p.parse_args(argv)
    if args.scan_root:
        df = scan_output_dirs(args.scan_root)
    elif args.wandb_project:
        df = from_wandb(args.wandb_project, args.wandb_entity)
    else:
        raise SystemExit("need --scan_root or --wandb_project")
    df.to_csv(args.output, index=False)
    print(f"wrote {len(df)} rows -> {args.output}")
    return df


if __name__ == "__main__":
    main()
