"""The port's CLS-feature extraction against JAX's on the CPU (the same
checkpoint pair and synthetic set as tests/test_torch_validate.py), and
the port's batch drivers over a CSV from the port's run-table scan."""

import json
import os

import numpy as np
import pytest

from tokenreduction_tpu.evaluation.extract_cls_features import (
    main as jax_extract,
)
from tokenreduction_tpu.evaluation.run_table import (
    scan_output_dirs as jax_scan,
)
from tokenreduction_tpu_torch.evaluation import extract_cls_features as E
from tokenreduction_tpu_torch.evaluation import (
    extract_cls_features_dirs,
    validate_dirs,
)
from tokenreduction_tpu_torch.evaluation.run_table import scan_output_dirs
from tokenreduction_tpu_torch.evaluation.validate import (
    NumpyArrayEncoder,
)
from tokenreduction_tpu_torch.evaluation.validate import main as validate
from torch_eval_cases import DATA, TINY, checkpoint_pair, read_json
from torch_threads import one_torch_thread  # noqa: F401

RED = dict(reduction_loc=(1, 3), keep_rate=(0.7,))
# run -> (registry name, model kwargs); depth 5, so blocks 6, 9 and 11
# have no features anywhere and take the largest recorded block's
RUNS = {"dense": ("deit_small_patch16_224_local", {}),
        "topk_07": ("topk_small_patch16_224", RED),
        "dpcknn_07": ("dpcknn_small_patch16_224", RED)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("extract")
    return root, {run: checkpoint_pair(root, name, run=run, **TINY, **kw)
                  for run, (name, kw) in RUNS.items()}


@pytest.mark.parametrize("run", list(RUNS))
def test_features_match_jax(run, runs, tmp_path):
    """The same .npy names, each (D, n) fp32, within 1e-4 of max|JAX|;
    blocks without recorded features repeat the largest recorded block's
    (at depth 5 blocks 6, 9 and 11 take block 4's; block 3 is its own)."""
    _, dirs = runs
    jax_dir, port_dir = dirs[run]
    flags = DATA + ["--feature_output_name", f"{run}_cls_features"]
    jax_extract(flags + ["--checkpoint", str(jax_dir), "--output_dir",
                         str(tmp_path / "jax")])
    out = E.main(flags + ["--device", "cpu", "--checkpoint", str(port_dir),
                          "--output_dir", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == sorted(
        f"{run}_cls_features_{b}.npy" for b in E.EXTRACT_BLOCKS)
    for b in E.EXTRACT_BLOCKS:
        name = f"{run}_cls_features_{b}.npy"
        want = np.load(tmp_path / "jax" / name)
        got = np.load(tmp_path / "port" / name)
        assert got.dtype == np.float32 and got.shape == want.shape == (
            TINY["embed_dim"], 16)
        np.testing.assert_array_equal(got, out[b])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    for b in (9, 11):
        np.testing.assert_array_equal(out[b], out[6])
    assert not np.array_equal(out[3], out[6])


def test_dirs_drivers_over_the_run_table(runs, tmp_path, capsys):
    """run_table's scan of the port's checkpoints gives JAX's scan of
    JAX's (but output_dir); validate_dirs writes each row's
    {Name}_viz_results.json (the deit row without Stage-* entries) and
    extract_cls_features_dirs its {Name}_cls_features_{b}.npy, equal to
    the per-run CLIs'; a second pass skips every existing row."""
    root, _ = runs
    df = scan_output_dirs(str(root / "port")).sort_values("Name")
    ref = jax_scan(str(root / "jax")).sort_values("Name")
    cols = [c for c in df.columns if c != "output_dir"]
    assert df[cols].to_dict("records") == ref[cols].to_dict("records")
    assert sorted(df["Name"]) == sorted(RUNS)
    csv = tmp_path / "overview.csv"
    df.to_csv(csv, index=False)
    out = tmp_path / "out"
    common = DATA + ["--csv", str(csv), "--output_dir", str(out),
                     "--device", "cpu"]
    validate_dirs.main(common)
    extract_cls_features_dirs.main(common)
    files = sorted(os.listdir(out))
    assert files == sorted(
        [f"{r}_viz_results.json" for r in RUNS] +
        [f"{r}_cls_features_{b}.npy" for r in RUNS
         for b in E.EXTRACT_BLOCKS])
    dense = read_json(out / "dense_viz_results.json")
    topk = read_json(out / "topk_07_viz_results.json")
    assert not any(k.startswith("Stage-") for k in
                   dense["synthetic_00000000.JPEG"])
    assert list(topk["synthetic_00000000.JPEG"])[3:] == ["Stage-1",
                                                         "Stage-3"]
    one = validate(DATA + ["--viz_mode", "--device", "cpu",
                           "--checkpoint", str(root / "port" / "topk_07")])
    assert read_json(out / "topk_07_viz_results.json") == json.loads(
        json.dumps(one, cls=NumpyArrayEncoder))
    feats = E.main(DATA + ["--device", "cpu", "--checkpoint",
                           str(root / "port" / "dpcknn_07")])
    for b in E.EXTRACT_BLOCKS:
        np.testing.assert_array_equal(
            np.load(out / f"dpcknn_07_cls_features_{b}.npy"), feats[b])

    stamps = {f: os.stat(out / f).st_mtime_ns for f in files}
    capsys.readouterr()
    validate_dirs.main(common)
    extract_cls_features_dirs.main(common)
    said = capsys.readouterr().out
    assert said.count("skip existing") == 2 * len(RUNS)
    assert {f: os.stat(out / f).st_mtime_ns for f in files} == stamps
