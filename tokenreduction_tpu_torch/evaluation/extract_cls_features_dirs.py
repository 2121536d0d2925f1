"""Batch CLS-feature extraction (counterpart of
``tokenreduction_tpu/evaluation/extract_cls_features_dirs.py``, reference
extract_cls_features_dirs.py): iterate the run-overview CSV and write
`{Name}_cls_features_{block}.npy`.

Reference driver flags mirrored (extract_cls_features_dirs.py:30-69):
`--dataset_csv` (`--csv` kept as an alias), `--parent_dir` re-roots the
CSV's run paths, `--overwrite_existing` re-runs rows whose feature files
already exist. The CSV is read as text, and --device/--platform,
--use_amp and -j go on to each run, as in validate_dirs.
"""

from __future__ import annotations

import argparse
import os

from tokenreduction_tpu_torch.evaluation import extract_cls_features as E
from tokenreduction_tpu_torch.evaluation.validate import (
    add_dirs_driver_args,
    check_dirs_driver_args,
    dirs_forward_args,
    read_csv_rows,
)
from tokenreduction_tpu_torch.evaluation.validate_dirs import resolve_run_dir


def main(argv=None, source=None):
    """The CLI; ``source`` goes on to each run's
    ``extract_cls_features.main``."""
    p = argparse.ArgumentParser("batch cls features")
    p.add_argument("--viz_mode", action="store_true",
                   help="no-op: extraction always runs the viz forward "
                        "(reference compat)")
    add_dirs_driver_args(p)
    args = p.parse_args(argv)
    check_dirs_driver_args(args)

    os.makedirs(args.output_dir, exist_ok=True)
    for row in read_csv_rows(args.csv):
        name = row["Name"]
        if not args.overwrite_existing and all(
                os.path.exists(os.path.join(
                    args.output_dir, f"{name}_cls_features_{b}.npy"))
                for b in E.EXTRACT_BLOCKS):
            print(f"skip existing {name}")
            continue
        run_dir = resolve_run_dir(row, args.parent_dir)
        if not os.path.isdir(run_dir):
            print(f"skip {name}: no run dir at {run_dir}")
            continue
        print(f"extracting {name}")
        argv_e = [
            "--data", args.data, "--dataset", args.dataset,
            "--checkpoint", run_dir,
            "-b", str(args.batch_size),
            "--input-size", str(args.input_size),
            "--output_dir", args.output_dir,
            "--feature_output_name", f"{name}_cls_features",
            "--synthetic-n", str(args.synthetic_n),
        ]
        E.main(argv_e + dirs_forward_args(args), source)


if __name__ == "__main__":
    main()
