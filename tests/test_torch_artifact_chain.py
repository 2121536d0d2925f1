"""The artifact chain on the port's artifacts: checkpoints -> validate
(viz JSON) -> extract (CLS .npy) -> run table -> ``analysis/``, once with
the JAX package's CLIs on its Orbax checkpoints and once with the port's
(``--device cpu``) on the checkpoints made from them through the weight
bridge. The analysis mains then run on each set, and the outputs must
agree: pruning and merging CSVs and the token statistics equal,
feature-metric CSVs (and what is collated and correlated from them)
within 1e-4.

Three of the golden fixture's runs (tests/test_reference_analysis_golden.py
RUNS: topk@0.7, dpcknn@0.7, tome@0.7 at "tiny" capacity, D=16), at 64 px
and 32 images; the golden test needs the reference tree mounted and skips
without it, so this test stands in for it on the port."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from analysis import (
    calculate_correlation,
    collate_data,
    compare_cls_features,
    compare_merging,
    compare_pruning,
    compute_token_statistics,
)
from tokenreduction_tpu.evaluation.extract_cls_features import (
    main as jax_extract,
)
from tokenreduction_tpu.evaluation.run_table import (
    scan_output_dirs as jax_scan,
)
from tokenreduction_tpu.evaluation.validate import main as jax_validate
from tokenreduction_tpu_torch.evaluation.extract_cls_features import (
    main as port_extract,
)
from tokenreduction_tpu_torch.evaluation.run_table import scan_output_dirs
from tokenreduction_tpu_torch.evaluation.validate import main as port_validate
from torch_eval_cases import checkpoint_pair
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings("ignore")

RUNS = [("topk", "0.7"), ("dpcknn", "0.7"), ("tome", "0.7")]
KW = dict(num_classes=7, img_size=64, embed_dim=16, num_heads=2,
          reduction_loc=(3, 6, 9))
DATA = ["--dataset", "synthetic", "--synthetic-n", "64", "--input-size",
        "64", "-b", "32"]
SIDES = {"jax": (jax_validate, jax_extract, jax_scan, []),
         "port": (port_validate, port_extract, scan_output_dirs,
                  ["--device", "cpu"])}
# (analysis output, compared exactly or within 1e-4)
CSVS = [("pruning_comparison_models_tiny_IM.csv", "equal"),
        ("cluster_comparison_models_tiny_IM.csv", "equal"),
        ("cls_features_comparison_models_tiny_IM.csv", 1e-4),
        ("collated_comparison_models_tiny_IM.csv", 1e-4),
        ("correlations_comparison_models_tiny_IM.csv", 1e-4)]


def analyse(art):
    """The analysis mains over one side's artifacts, into art/out."""
    csv, out = os.path.join(art, "overview.csv"), os.path.join(art, "out")
    common = ["--parent_dir", art, "--dataset_csv", csv]
    models = ["--mode", "models"]
    tiny = ["--capacity", "tiny"]
    compare_pruning.main(models + common + tiny + [
        "--output_file", CSVS[0][0], "--output_dir", out])
    compare_merging.main(models + common + tiny + [
        "--output_file", CSVS[1][0], "--output_dir", out])
    compare_cls_features.main(models + common + tiny + [
        "--output_file", CSVS[2][0], "--output_dir", out])
    compute_token_statistics.main(common + [
        "--output_file", "token_stats_IM.json", "--output_dir", out])
    collate_data.main(models + ["--parent_dir", out, "--datasets", "IM",
                                "--capacities", "tiny", "--output_dir",
                                out])
    calculate_correlation.main(models + [
        "--parent_dir", out, "--datasets", "IM", "--capacities", "tiny",
        "--output_dir", out])
    return out


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    # each run its own init, as separately trained runs are: runs that
    # share a backbone init share their CLS features up to the first
    # reduction, and CCA on a matrix against itself is degenerate
    for seed, (method, rate) in enumerate(RUNS):
        name = f"{method}_{rate.replace('.', '')}"
        checkpoint_pair(root / "runs", f"{method}_tiny_patch16_224",
                        run=name, seed=seed, keep_rate=(float(rate),), **KW)
    outs = {}
    for side, (validate, extract, scan, device) in SIDES.items():
        art = str(root / side)
        runs = str(root / "runs" / side)
        for method, rate in RUNS:
            name = f"{method}_{rate.replace('.', '')}"
            run = os.path.join(runs, name)
            validate(DATA + device + [
                "--checkpoint", run, "--viz_mode", "--output_dir", art,
                "--viz_output_name", f"{name}_viz_results.json"])
            extract(DATA + device + [
                "--checkpoint", run, "--output_dir", art,
                "--feature_output_name", f"{name}_cls_features"])
        scan(runs).to_csv(os.path.join(art, "overview.csv"), index=False)
        outs[side] = analyse(art)
    return outs


def test_comparisons_are_real(chains):
    """The port's chain computed pairwise metrics: topk <-> dpcknn
    pruning, dpcknn <-> tome merging, every same-ratio feature pair."""
    out = chains["port"]
    pruning, cluster, cls = (pd.read_csv(os.path.join(out, name), sep=";")
                             for name, _ in CSVS[:3])
    assert len(pruning) >= 2 and len(cluster) >= 2 and len(cls) >= 6
    assert np.isfinite(pruning["Stage-3-Mean"]).all()
    assert np.isfinite(cluster["NMI-Stage-3-Mean"]).all()
    assert np.isfinite(cls["3-PWCCA"]).all()


@pytest.mark.parametrize("name,tol", CSVS,
                         ids=[c[0].split("_comparison")[0] for c in CSVS])
def test_analysis_csv_matches_jax_chain(chains, name, tol):
    want = pd.read_csv(os.path.join(chains["jax"], name), sep=";")
    got = pd.read_csv(os.path.join(chains["port"], name), sep=";")
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    for c in want.columns:
        if want[c].dtype.kind in "fc":
            if tol == "equal":
                np.testing.assert_array_equal(got[c].values,
                                              want[c].values, err_msg=c)
            else:
                np.testing.assert_allclose(got[c].values, want[c].values,
                                           rtol=0, atol=tol, err_msg=c)
        else:
            assert (got[c].astype(str) == want[c].astype(str)).all(), c


def test_token_statistics_match_jax_chain(chains):
    want, got = (json.load(open(os.path.join(chains[side],
                                             "token_stats_IM.json")))
                 for side in ("jax", "port"))
    assert got == want
