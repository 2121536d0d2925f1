"""Batch validation driver (counterpart of
``tokenreduction_tpu/evaluation/validate_dirs.py``, reference
validate_dirs.py): iterate the run-overview CSV, validate each run's best
checkpoint in viz mode, and write `{Name}_viz_results.json` under
--output_dir.

Reference semantics mirrored (validate_dirs.py:16-77): `--dataset_csv`
(`--csv` kept as an alias), `--parent_dir` re-roots the CSV's run paths,
`--overwrite_existing` re-runs rows whose viz JSON already exists, and
plain-deit rows are validated with viz_mode off -- their per-row
predictions/accuracy JSON is still written under `{Name}_viz_results
.json` (reference validate_dirs.py:57-66 sets viz_output_name for every
row), it just carries no Stage-* reduction entries. The CSV is read as
text (the csv module; only the Name, model and output_dir columns are
used), and --device/--platform, --use_amp and -j go on to each run.
"""

from __future__ import annotations

import argparse
import os

from tokenreduction_tpu_torch.evaluation import validate as V
from tokenreduction_tpu_torch.evaluation.validate import (
    add_dirs_driver_args,
    check_dirs_driver_args,
    dirs_forward_args,
    read_csv_rows,
)


def resolve_run_dir(row, parent_dir: str) -> str:
    """The CSV's output_dir points at the run directory (run_table.py
    scan mode) -- or, for W&B exports where output_dir is the parent,
    at output_dir/Name (reference validate_dirs.py:46). Try both,
    re-rooted under --parent_dir."""
    base = str(row["output_dir"])
    if parent_dir and parent_dir != ".":
        # reference: parent_dir + path[1:] (strip the leading "." of
        # relative "./runs/..." paths). Strip exactly the "./" prefix --
        # lstrip("./") would eat "../" and the root of absolute paths.
        if base.startswith("./"):
            base = base[2:]
        # os.path.join keeps absolute output_dir paths absolute.
        base = os.path.join(parent_dir, base)
    joined = os.path.join(base, str(row["Name"]))
    if os.path.basename(os.path.normpath(base)) != str(row["Name"]) \
            and os.path.isdir(joined):
        return joined
    return base


def main(argv=None, source=None):
    """The CLI; ``source`` goes on to each run's ``validate.main``."""
    p = argparse.ArgumentParser("batch validate")
    # on by default (this driver exists to produce the viz JSONs); the
    # reference requires the explicit flag (validate_dirs.py:28) --
    # accept it, and offer --no-viz_mode for accuracy-only batch runs
    p.add_argument("--viz_mode", action="store_true", default=True)
    p.add_argument("--no-viz_mode", dest="viz_mode", action="store_false",
                   help="accuracy-only pass for every row (the per-row "
                        "predictions JSON is still written, without "
                        "Stage-* entries -- reference semantics)")
    add_dirs_driver_args(p)
    args = p.parse_args(argv)
    check_dirs_driver_args(args)

    os.makedirs(args.output_dir, exist_ok=True)
    for row in read_csv_rows(args.csv):
        model = str(row["model"])
        run_dir = resolve_run_dir(row, args.parent_dir)
        if not os.path.isdir(run_dir):
            print(f"skip {row['Name']}: no run dir at {run_dir}")
            continue
        # plain deit has no reduction stages: viz off for the row, but
        # its predictions/accuracy JSON is still written under the
        # row's name (reference validate_dirs.py:57-66)
        viz = args.viz_mode and not (
            model.startswith("deit") and "viz" not in model)
        # every row writes {Name}_viz_results.json, so skip-existing
        # applies to every row (reference validate_dirs.py:65-68)
        out_name = f"{row['Name']}_viz_results.json"
        if not args.overwrite_existing and \
                os.path.exists(os.path.join(args.output_dir, out_name)):
            print(f"skip existing {out_name}")
            continue
        print(f"validating {row['Name']}")
        argv_v = [
            "--data", args.data, "--dataset", args.dataset,
            "--checkpoint", run_dir,
            "-b", str(args.batch_size),
            "--input-size", str(args.input_size),
            "--output_dir", args.output_dir,
            "--viz_output_name", out_name,
            "--synthetic-n", str(args.synthetic_n),
        ]
        if viz:
            argv_v += ["--viz_mode"]
        V.main(argv_v + dirs_forward_args(args), source)


if __name__ == "__main__":
    main()
