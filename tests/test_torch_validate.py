"""The port's validate CLI against JAX's on the CPU: both read the same
checkpoint pair (a Flax init as JAX's Orbax checkpoint, and the port's
made from it through the weight bridge) and run over the same synthetic
set, JAX in fp32 with its tests' settings and the port with ``--device
cpu``; the viz JSONs they write must match (torch_eval_cases
``assert_viz_equal``): kept tokens and assignment maps exactly, losses
and multilabel probabilities within 1e-4, top-1, top-5 and Params
equal."""

import math

import numpy as np
import pytest
import torch

from tokenreduction_tpu.evaluation.validate import count_params as jax_count
from tokenreduction_tpu.evaluation.validate import main as jax_validate
from tokenreduction_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from tokenreduction_tpu_torch.evaluation import validate as V
from tokenreduction_tpu_torch.utils.checkpoint import load_checkpoint
from torch_eval_cases import (
    DATA,
    TINY,
    assert_viz_equal,
    checkpoint_pair,
    read_json,
)
from torch_threads import one_torch_thread  # noqa: F401

RED = dict(reduction_loc=(1, 3), keep_rate=(0.7,))
METHODS = ("topk", "evit", "tome", "sit", "patchmerger", "sinkhorn",
           "dpcknn", "kmedoids", "ats", "heuristic", "dyvit")
# case -> (registry name, model kwargs, validate flags, checkpoint options)
CASES = {m: (f"{m}_small_patch16_224", RED, ["--viz_mode"], {})
         for m in METHODS}
CASES.update({
    # dense has no reduction stages: validated without viz, as
    # validate_dirs does for deit rows; --platform names the CPU
    "dense": ("deit_small_patch16_224_local", {}, [], {}),
    # a cluster method whose reduction_loc is not in order (its JSON
    # carries assignment maps, which are not chained: the kept-token
    # chaining of k-medoids and DPC-KNN assumes ascending blocks, in JAX too)
    "sinkhorn loc (2, 1)": ("sinkhorn_small_patch16_224",
                            dict(reduction_loc=(2, 1), keep_rate=(0.7,)),
                            ["--viz_mode"], {}),
    # the EMA params were best: both sides validate them
    "topk ema_best": ("topk_small_patch16_224", RED, ["--viz_mode"],
                      dict(ema_best=True)),
    "topk no viz": ("topk_small_patch16_224", RED, [], {}),
    # mAP over sigmoid probabilities
    "sit multilabel": ("sit_small_patch16_224",
                       dict(RED, num_classes=20), ["--viz_mode"],
                       dict(dataset="synthetic_multilabel")),
})


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("validate")
    made = {}

    def get(case):
        if case not in made:
            name, kw, _, opts = CASES[case]
            made[case] = checkpoint_pair(
                root, name, run=case.replace(" ", "_"),
                ema_best=opts.get("ema_best", False), **{**TINY, **kw})
        return made[case]

    return get


def data_flags(case):
    dataset = CASES[case][3].get("dataset")
    return DATA if dataset is None else \
        [dataset if a == "synthetic" else a for a in DATA]


@pytest.mark.parametrize("case", list(CASES))
def test_viz_json_matches_jax(case, checkpoints, tmp_path):
    """Every method's viz JSON (dense's predictions JSON) equals JAX's:
    EViT's -1 chained to the fused token, heuristic's Kept_Tokens_Abs
    over its contiguous range (blocks 1-3), ATS's pads dropped, DyViT's
    and topk's stage-local ids chained, the cluster family's assignment
    maps; and the port's Params count equals JAX's count_params."""
    jax_dir, port_dir = checkpoints(case)
    flags = data_flags(case) + CASES[case][2]
    device = ["--platform", "cpu"] if case == "dense" else \
        ["--device", "cpu"]
    jax_validate(flags + ["--checkpoint", str(jax_dir), "--output_dir",
                          str(tmp_path), "--viz_output_name", "jax.json"])
    V.main(flags + device + ["--checkpoint", str(port_dir), "--output_dir",
                             str(tmp_path), "--viz_output_name",
                             "port.json"])
    want = read_json(tmp_path / "jax.json")
    got = read_json(tmp_path / "port.json")
    assert_viz_equal(want, got)
    images = [k for k in want if k.startswith("synthetic_")]
    assert len(images) == 16
    stages = [k for k in want[images[0]] if k.startswith("Stage-")]
    if "--viz_mode" in flags:
        loc = CASES[case][1]["reduction_loc"]
        assert stages == [f"Stage-{i}" for i in (
            (1, 2, 3) if case == "heuristic" else loc)]
    else:
        assert stages == []
    tree, _ = jax_load_checkpoint(str(jax_dir / "best_checkpoint"))
    ptree, _ = load_checkpoint(str(port_dir / "best_checkpoint"))
    assert V.count_params(ptree["params"]) == jax_count(tree["params"])
    if case == "evit":
        # the last stage's fused token: -1 wraps to the previous stage's
        # last kept id (numpy indexing, as in JAX)
        assert any(len(set(want[k]["Stage-3"]["Kept_Token"])) <
                   len(want[k]["Stage-3"]["Kept_Token"]) or
                   want[k]["Stage-3"]["Kept_Token"][-1] ==
                   want[k]["Stage-1"]["Kept_Token"][-1] for k in images)
    if case == "sit multilabel":
        assert want["Top1-Acc"] == want["Top5-Acc"] == got["Top1-Acc"]
        assert len(got[images[0]]["Predictions"]) == 20


def test_use_amp_schema_and_fp32_logits(checkpoints, tmp_path, capsys,
                                        monkeypatch):
    """--use_amp on the CPU: the bf16 model's logits reach the host as
    fp32, the JSON has the fp32 run's schema (every image, Stage-* and
    field), and TF32 is left as it was; an fp32 run turns it off for
    cuBLAS and cuDNN."""
    _, port_dir = checkpoints("topk")
    hosted = []
    to_host = V.to_host
    monkeypatch.setattr(V, "to_host",
                        lambda t: hosted.append(t.dtype) or to_host(t))
    flags = DATA + ["--viz_mode", "--device", "cpu", "--checkpoint",
                    str(port_dir), "--output_dir", str(tmp_path)]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        amp = V.main(flags + ["--use_amp", "--viz_output_name", "amp.json"])
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        assert "NOTE: --use_amp viz extraction" in capsys.readouterr().out
        fp32 = V.main(flags + ["--viz_output_name", "fp32.json"])
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert torch.bfloat16 in hosted
    amp, fp32 = (read_json(tmp_path / f) for f in ("amp.json", "fp32.json"))
    assert list(amp) == list(fp32)
    for key, rec in fp32.items():
        if isinstance(rec, dict):
            assert list(amp[key]) == list(rec)
            assert len(amp[key]["Predictions"]) == 5
            assert math.isfinite(amp[key]["Loss"])
            for stage in (k for k in rec if k.startswith("Stage-")):
                assert list(amp[key][stage]) == ["Kept_Token"]
    logits = V.to_host(torch.ones(2, 3, dtype=torch.bfloat16))
    assert logits.dtype == np.float32


def test_device_flags():
    """--device names the device, --platform cpu / gpu / cuda too; an
    unknown platform or a disagreeing pair is refused, and with neither
    the card is required."""
    parse = V.get_parser().parse_args
    assert V.eval_device(parse(["--device", "cpu"])).type == "cpu"
    assert V.eval_device(parse(["--platform", "cpu"])).type == "cpu"
    with pytest.raises(ValueError, match="tpu"):
        V.eval_device(parse(["--platform", "tpu"]))
    with pytest.raises(ValueError, match="disagree"):
        V.eval_device(parse(["--device", "cpu", "--platform", "gpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            V.eval_device(parse([]))


def test_dense_viz_mode_writes_the_predictions_json(checkpoints, tmp_path):
    """A dense model without captured features returns no viz data: in
    viz mode (the plain composition) the port writes the JSON it writes
    without viz, with no Stage-* entry (the JAX CLI unpacks the logits'
    batch axis instead)."""
    _, port_dir = checkpoints("dense")
    flags = DATA + ["--device", "cpu", "--checkpoint", str(port_dir),
                    "--output_dir", str(tmp_path)]
    V.main(flags + ["--viz_mode", "--viz_output_name", "viz.json"])
    V.main(flags + ["--viz_output_name", "plain.json"])
    viz, plain = read_json(tmp_path / "viz.json"), read_json(
        tmp_path / "plain.json")
    assert_viz_equal(plain, viz, tol=1e-6)
    assert not any(k.startswith("Stage-") for rec in viz.values()
                   if isinstance(rec, dict) for k in rec)
