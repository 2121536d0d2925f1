"""Worker of tests/test_torch_parallel.py: the port's multi-process runs
over gloo on the CPU, one process a rank (``parallel/launch.py::spawn``
starts them with torchrun's environment).

``python tests/torch_mp_worker.py JOB INPUTS OUT``: INPUTS is a
``torch.save`` of the parent's inputs (the start params as a state dict,
the global batches, mixup's draws), OUT the file rank 0 writes its
results to. Each rank takes its rows of every global batch through
``parallel/mesh.py::global_order``, so that the parent's single-process
references run on the global batches as they are. Jobs:

- ``ddp``: tests/mp_worker.py's recipe (topk tiny, SGD, clip 1.0, mixup
  on the parent's draws, accumulation 2, EMA 0.99, two steps), then the
  ``--dist-eval`` accuracy and multilabel mAP of the final params.
  Every step's loss and gradient norm are recorded.
- ``fsdp``: for each optimizer of the inputs, two FSDP steps (min_size
  64, drop-path 0.1 from one seeded generator, EMA, Adam's eps ``EPS``)
  and the whole state
  gathered; with AdamW the checkpoint written too (rank 0). At the
  inputs' ``dims``: WIDE's 128 wide blocks give Adafactor factored
  moments, and its 129 classes a head split along its second dim.

Imports the port only (no JAX), as the port's processes do.
"""

import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tokenreduction_tpu_torch import create_model  # noqa: E402
from tokenreduction_tpu_torch.parallel.mesh import (  # noqa: E402
    DataParallel,
    global_order,
    init_distributed,
)
from tokenreduction_tpu_torch.train import losses  # noqa: E402
from tokenreduction_tpu_torch.train.mixup import (  # noqa: E402
    MixupConfig,
    MixupDraw,
    mix,
)
from tokenreduction_tpu_torch.train.optim import (  # noqa: E402
    OptimConfig,
    create_optimizer,
)
from tokenreduction_tpu_torch.train.step import (  # noqa: E402
    StepConfig,
    init_train_state,
    make_eval_step,
    make_train_step,
)

NUM_CLASSES = 5
TINY = dict(num_classes=NUM_CLASSES, img_size=32, embed_dim=32, num_heads=2,
            depth=3, patch_size=8, reduction_loc=(1,), keep_rate=(0.7,))
# Adafactor factors a leaf whose two largest dims are 128 or more; the
# head's odd 129 rows leave its 128 columns to split over two ranks
WIDE = dict(TINY, num_classes=129, embed_dim=128)
ACCUM = 2
N_VAL, VAL_BATCH = 10, 4
# the fsdp job's Adam eps: with |g| well below it, g / (|g| + eps) is near
# linear in g, so two reduction orders compared over several steps show
# the sharding and not Adam's conditioning near g = 0, which turns
# rounding gaps into update gaps of up to 2 lr (tests/torch_trajectory.py)
EPS = 1e-3


def build_model(params, dims=TINY, **kw):
    model, _ = create_model("topk_small_patch16_224", device="cpu",
                            **dims, **kw)
    model.load_state_dict(params, strict=True)
    return model


def local_rows(batch: dict, world: int, rank: int, groups: int) -> dict:
    n = len(batch["label"]) // world
    rows = global_order(world, groups, n)[rank * n:(rank + 1) * n]
    return {k: v[rows] for k, v in batch.items()}


def ddp_run(inp: dict, dp=None, world: int = 1, rank: int = 0) -> dict:
    """The ddp job's steps and evals; one process with ``dp`` None (the
    parent's port reference on the whole batches)."""
    model = build_model(inp["params"])
    opt, _ = create_optimizer(
        dict(model.named_parameters()),
        OptimConfig(opt="sgd", lr=1e-3, clip_grad=1.0), lambda s: 1e-3, [],
        steps_per_epoch=2)
    draws = iter([MixupDraw(**d) for d in inp["draws"]])
    cfg = MixupConfig(num_classes=NUM_CLASSES)
    step = make_train_step(
        model, lambda out, t, i, p: losses.soft_target_ce(out, t), opt,
        StepConfig(grad_accum_steps=ACCUM, ema_decay=0.99), None,
        lambda x, y: mix(x, y, cfg, next(draws)), dp=dp)
    state = init_train_state(model, opt, ema=True, device="cpu", dp=dp)
    out = {"losses": []}
    for gb in inp["batches"]:
        state, m = step(state, local_rows(gb, world, rank, ACCUM))
        out["losses"].append([float(m["loss"]), float(m["grad_norm"])])
    out["params"] = {n: t.detach().clone() for n, t in state.params.items()}
    out["ema"] = {n: t.clone() for n, t in state.ema_params.items()}
    out["stats"], out["map"] = evaluate_both(model, state.params, world,
                                             rank)
    return out


def evaluate_both(model, params, world: int, rank: int):
    """(top-1/top-5/loss, multilabel mAP) of ``params`` on the synthetic
    val sets, each rank on its DistributedEvalSampler split when world >
    1."""
    from tokenreduction_tpu_torch.data import (
        DistributedEvalSampler,
        Loader,
        ShardedSampler,
    )
    from tokenreduction_tpu_torch.data.datasets import SyntheticDataset
    from tokenreduction_tpu_torch.data.transforms import (
        normalize,
        to_float_array,
    )
    from tokenreduction_tpu_torch.train.loop import evaluate

    def tf(img, rng):
        return normalize(to_float_array(img))

    def loader(multilabel, seed):
        sampler = (DistributedEvalSampler(N_VAL, world, rank) if world > 1
                   else ShardedSampler(N_VAL, 1, 0, shuffle=False))
        ds = SyntheticDataset(n=N_VAL, num_classes=NUM_CLASSES, img_size=32,
                              multilabel=multilabel, seed=seed)
        return Loader(ds, sampler, VAL_BATCH, tf, pad_partial=True)

    stats = evaluate(make_eval_step(model), params, loader(False, 7), "cpu",
                     False, dist_eval=world > 1)
    ml = evaluate(make_eval_step(model, multilabel=True), params,
                  loader(True, 9), "cpu", True, dist_eval=world > 1)
    return stats, ml["acc1"]


def fsdp_run(inp: dict, opt_name: str, dp=None, world: int = 1,
             rank: int = 0, steps: int = 2, state=None):
    """Two steps of ``opt_name`` from the start params (or from
    ``state``); returns (state, [loss, grad norm] a step, model,
    optimizer)."""
    model = build_model(inp["params"], inp.get("dims", TINY),
                        drop_path_rate=0.1)
    opt, _ = create_optimizer(
        dict(model.named_parameters()),
        OptimConfig(opt=opt_name, lr=1e-3, clip_grad=1.0, weight_decay=0.05,
                    opt_eps=EPS),
        lambda s: 1e-3, [], steps_per_epoch=4)
    gen = torch.Generator().manual_seed(11)
    step = make_train_step(
        model, lambda out, t, i, p: losses.cross_entropy(out, t), opt,
        StepConfig(ema_decay=0.99), gen, dp=dp)
    if state is None:
        state = init_train_state(model, opt, ema=True, device="cpu", dp=dp)
    first = state.step
    out = []
    for gb in inp["batches"][first:first + steps]:
        state, m = step(state, local_rows(gb, world, rank, 1))
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return state, out, model, opt


def main():
    job, inputs, out_path = sys.argv[1:4]
    info = init_distributed("cpu")
    world, rank = info["process_count"], info["process_index"]
    inp = torch.load(inputs, weights_only=False)
    if job == "ddp":
        res = ddp_run(inp, DataParallel(), world, rank)
        summary = {"losses": res["losses"], "stats": res["stats"],
                   "map": res["map"]}
    else:
        from tokenreduction_tpu_torch.utils.checkpoint import save_checkpoint

        res, summary = {}, {}
        for name in inp["optimizers"]:
            dp = DataParallel(fsdp=True, min_size=64)
            state, got, _, opt = fsdp_run(inp, name, dp, world, rank)
            whole = dp.full_state(state, opt)
            res[name] = dict(whole, losses=got,
                             split=sorted(dp.split()),
                             local={n: tuple(t.shape)
                                    for n, t in state.params.items()})
            summary[name] = got
            if name == "adamw" and rank == 0:
                save_checkpoint(os.path.join(os.path.dirname(out_path),
                                             "ckpt"), epoch=0,
                                step=state.step, **whole)
    if rank == 0:
        torch.save(res, out_path)
    import torch.distributed as dist

    dist.destroy_process_group()
    print("RESULT " + json.dumps({"rank": rank, "world": world,
                                  **summary}), flush=True)


if __name__ == "__main__":
    np.seterr(all="ignore")
    main()
