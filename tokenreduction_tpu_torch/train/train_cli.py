"""Train CLI of the PyTorch port (counterpart of
``tokenreduction_tpu/train/train_cli.py``; reference train.py:34-237 flag
surface).

The same flags as the JAX CLI, with its two-pass parse of the
method-specific flags on ``--model`` (reference train.py:203-236). The run
is ``train/loop.py::run_training``, on the card unless ``--device cpu``
(or ``--platform cpu``) is given; without a card and without either it
raises. ``--device`` is the port's device flag, as in the port's
``validate``. Several processes train together (``parallel/mesh.py``)
when torchrun starts them, or with the reference's ``--world_size`` and
``--dist_url`` and each process's ``RANK`` (and ``LOCAL_RANK``) in its
environment: data parallel, or FSDP with ``--fsdp``; NCCL with a card a
process, gloo with ``--device cpu``. ``--model-ema-force-cpu`` raises as
in JAX, and so do ``--pretrained`` and an ``http`` ``--teacher-path``,
which would download weights (pass a local .pth). The reference's
DataLoader plumbing flags parse, each with a notice that it has no
effect.

Usage:
  python -m tokenreduction_tpu_torch.train.train_cli \\
      --model topk_small_patch16_224 --dataset imagenet --data /path \\
      --reduction_loc 3 6 9 --keep_rate 0.7 --epochs 30 ...
  torchrun --nproc_per_node 4 -m tokenreduction_tpu_torch.train.train_cli \\
      --fsdp ...
"""

from __future__ import annotations

import argparse

from tokenreduction_tpu_torch.models.convert import refuse_download
from tokenreduction_tpu_torch.train.loop import run_training


def get_args_parser():
    parser = argparse.ArgumentParser(
        "Token reduction finetuning (PyTorch port)", add_help=False)
    parser.add_argument("--batch-size", default=64, type=int,
                        help="per-host device batch (pre-accumulation)")
    parser.add_argument("--epochs", default=300, type=int)
    parser.add_argument("--bce-loss", action="store_true")
    parser.add_argument("--unscale-lr", action="store_true")

    # model
    parser.add_argument("--model", default="deit_base_patch16_224_local",
                        type=str)
    parser.add_argument("--input-size", default=224, type=int)
    parser.add_argument("--drop", type=float, default=0.0)
    parser.add_argument("--drop-path", type=float, default=0.1)

    # EMA
    parser.add_argument("--model-ema", action="store_true")
    parser.add_argument("--no-model-ema", action="store_false",
                        dest="model_ema")
    parser.set_defaults(model_ema=True)
    parser.add_argument("--model-ema-decay", type=float, default=0.99996)

    # optimizer
    parser.add_argument("--opt", default="adamw", type=str)
    parser.add_argument("--opt-eps", default=1e-8, type=float)
    parser.add_argument("--opt-betas", default=None, type=float, nargs="+")
    parser.add_argument("--clip-grad", type=float, default=None)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight-decay", type=float, default=0.05)

    # schedule
    parser.add_argument("--sched", default="cosine", type=str)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--warmup-lr", type=float, default=1e-6)
    parser.add_argument("--min-lr", type=float, default=1e-5)
    parser.add_argument("--decay-epochs", type=float, default=30)
    parser.add_argument("--warmup-epochs", type=int, default=5)
    parser.add_argument("--cooldown-epochs", type=int, default=0)
    parser.add_argument("--patience-epochs", type=int, default=10)
    parser.add_argument("--decay-rate", "--dr", type=float, default=0.1)
    # lr noise (reference scheduler_factory.py:13-22,46-48)
    parser.add_argument("--lr-noise", type=float, nargs="+", default=None,
                        help="epoch fractions at which LR noise turns on "
                             "([start] or [start, end))")
    parser.add_argument("--lr-noise-pct", type=float, default=0.67)
    parser.add_argument("--lr-noise-std", type=float, default=1.0)

    # augmentation
    parser.add_argument("--color-jitter", type=float, default=0.3)
    parser.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1")
    parser.add_argument("--smoothing", type=float, default=0.1)
    parser.add_argument("--train-interpolation", type=str, default="bicubic")
    parser.add_argument("--ThreeAugment", action="store_true")
    parser.add_argument("--src", action="store_true",
                        help="simple random crop instead of RRC")
    parser.add_argument("--profile_dir", default="", type=str,
                        help="write a torch.profiler trace of the first "
                             "epoch (trace.json)")
    parser.add_argument("--dist-eval", action="store_true", default=False,
                        help="shard the val set across processes "
                             "(reference train.py:284-290; padding may "
                             "duplicate a few tail samples)")
    parser.add_argument("--repeated-aug", action="store_true")
    parser.add_argument("--no-repeated-aug", action="store_false",
                        dest="repeated_aug")
    parser.set_defaults(repeated_aug=True)
    parser.add_argument("--reprob", type=float, default=0.25)
    parser.add_argument("--remode", type=str, default="pixel")
    parser.add_argument("--recount", type=int, default=1)

    # mixup
    parser.add_argument("--mixup", type=float, default=0.8)
    parser.add_argument("--cutmix", type=float, default=1.0)
    parser.add_argument("--cutmix-minmax", type=float, nargs="+",
                        default=None,
                        help="cutmix min/max box-side ratio; overrides "
                             "alpha and enables cutmix (reference "
                             "train.py:134)")
    parser.add_argument("--mixup-prob", type=float, default=1.0)
    parser.add_argument("--mixup-switch-prob", type=float, default=0.5)
    parser.add_argument("--mixup-mode", type=str, default="batch")

    # distillation
    parser.add_argument("--teacher-model", default="regnety_160", type=str)
    parser.add_argument("--teacher-path", type=str, default="")
    parser.add_argument("--distillation-type", default="none",
                        choices=["none", "soft", "hard"], type=str)
    parser.add_argument("--distillation-alpha", default=0.5, type=float)
    parser.add_argument("--distillation-tau", default=1.0, type=float)
    # convnet-teacher capacity overrides (tiny CPU-runnable configs; the
    # defaults build the full regnety_160)
    parser.add_argument("--teacher-regnet-depths", type=int, nargs="+",
                        default=None)
    parser.add_argument("--teacher-regnet-widths", type=int, nargs="+",
                        default=None)
    parser.add_argument("--teacher-regnet-group-width", type=int,
                        default=None)
    parser.add_argument("--teacher-regnet-stem-width", type=int,
                        default=None)

    # finetune
    parser.add_argument("--finetune", default="",
                        help="timm .pth or Brain-Flax ViT .npz checkpoint "
                        "to convert and load")
    parser.add_argument("--pretrained", action="store_true",
                        help="bootstrap from the FB DeiT release weights "
                             "(downloaded+cached; reference "
                             "models_act.py:88-96)")

    # data
    parser.add_argument("--data", default="", type=str)
    parser.add_argument("--dataset", default="imagenet",
                        choices=["imagenet", "nabirds", "coco", "nuswide", "cached",
                                 "synthetic", "synthetic_multilabel"])
    parser.add_argument("--synthetic-n", default=256, type=int)
    parser.add_argument("--synthetic-classes", default=1000, type=int)
    parser.add_argument("--num-workers", "--num_workers", default=0,
                        type=int, dest="num_workers",
                        help="decode worker processes (0 = in-process "
                             "prefetch thread); --num_workers is the "
                             "reference spelling (train.py:101)")

    parser.add_argument("--output_dir", default="")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--resume", default="")
    parser.add_argument("--start_epoch", default=0, type=int)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--print-freq", default=100, type=int)

    # logging
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--wandb_project",
                        default="Token Reduction Training", type=str)
    parser.add_argument("--wandb_group", default="MISC", type=str)
    parser.add_argument("--wandb_watch", action="store_true",
                        help="log per-module param/grad norms "
                             "(wandb.watch equivalent, train.py:561)")

    # backbone LR control
    parser.add_argument("--backbone_lr_scale", default=1.0, type=float)
    parser.add_argument("--backbone_freeze_steps", default=0, type=int)
    parser.add_argument("--constant_cls", action="store_true")
    parser.add_argument("--constant_pos", action="store_true")
    parser.add_argument("--attn-only", action="store_true",
                        help="train only attention + head + pos_embed "
                             "(reference train.py:372-392)")
    parser.add_argument("--train-mode", action="store_true")
    parser.add_argument("--no-train-mode", action="store_false",
                        dest="train_mode",
                        help="run the training forward in eval mode "
                             "(deit finetuning; reference train.py:111)")
    parser.set_defaults(train_mode=True)

    parser.add_argument("--use_amp", action="store_true",
                        help="bf16 forward over bf16 copies of the fp32 "
                             "masters (JAX's recipe)")
    parser.add_argument("--sched_in_steps", action="store_true")
    parser.add_argument("--grad_accum_steps", default=1, type=int)
    parser.add_argument("--steps_per_call", default=1, type=int,
                        help="JAX fuses this many steps into one call; the "
                        "port prints a NOTE and runs them one by one")
    parser.add_argument("--fsdp", action="store_true",
                        help="hold the masters, moments and EMA as shards "
                        "over the processes (parallel/mesh.py)")
    parser.add_argument("--device_aug", action="store_true",
                        help="augment on the card: the host copies uint8 "
                        "squares (data/device_aug.py)")
    parser.add_argument("--lr_batch_normalizer", default=512, type=float)
    parser.add_argument("--save_more_than_best", action="store_true")

    # reduction args
    parser.add_argument("--reduction_loc", type=int, nargs="+", default=[])
    parser.add_argument("--keep_rate", type=float, nargs="+", default=[])

    # tiny-model overrides (tests / smoke runs)
    parser.add_argument("--embed-dim", default=None, type=int)
    parser.add_argument("--depth", default=None, type=int)
    parser.add_argument("--num-heads", default=None, type=int)
    parser.add_argument("--patch-size", default=None, type=int)

    parser.add_argument("--platform", default="", type=str,
                        help="cpu, or gpu / cuda (the JAX CLI's flag; "
                        "--device names the device too)")
    return parser


def add_method_args(parser, model_name: str):
    """Conditional per-method flags (reference train.py:205-236)."""
    if "dyvit" in model_name:
        parser.add_argument("--token_distill_weight", default=0.5,
                            type=float)
        parser.add_argument("--cls_distill_weight", default=0.5, type=float)
        parser.add_argument("--ratio_weight", default=2.0, type=float)
        parser.add_argument("--cls_weight", default=1.0, type=float)
        parser.add_argument("--mse_token", action="store_true")
        parser.add_argument("--dyvit_distill", action="store_true")
        parser.add_argument("--no_dyvit_teacher", action="store_true")
        parser.add_argument("--dyvit_teacher_weights", default="", type=str)
    if "dpcknn" in model_name:
        parser.add_argument("--k_neighbors", default=5, type=int)
    if "heuristic" in model_name:
        parser.add_argument("--heuristic_pattern", type=str, default="l1",
                            choices={"l1", "l2", "linf"})
        parser.add_argument("--min_radius", type=float, default=1.0)
        parser.add_argument("--not_contiguous", action="store_true")
    if "sinkhorn" in model_name:
        parser.add_argument("--sinkhorn_eps", type=float, default=1.0)
    if "kmedoids" in model_name or "sinkhorn" in model_name:
        parser.add_argument("--cluster_iters", type=int, default=3)
    if "kmedoids" in model_name or "dpcknn" in model_name:
        parser.add_argument("--equal_weight", action="store_true")
    return parser


def parse_args(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", default="deit_base_patch16_224_local",
                     type=str)
    known, _ = pre.parse_known_args(argv)
    parser = argparse.ArgumentParser(
        "Token reduction finetuning (PyTorch port)",
        parents=[get_args_parser()])
    add_method_args(parser, known.model)
    add_reference_compat_args(parser)
    args = parser.parse_args(argv)
    check_reference_compat_args(args)
    check_ported(args)
    return args


def check_ported(args):
    """Raise on a flag that would download weights; nothing is ignored
    silently."""
    if args.pretrained and not args.finetune:
        refuse_download("--pretrained", "--finetune")
    if args.teacher_path.startswith("http"):
        refuse_download("an http --teacher-path", "--teacher-path")


# Reference train.py flags with no meaning here (DataLoader plumbing) or
# dead in the reference itself. Accepted so verbatim reference commands
# parse, but never silently: using one prints a notice. --device is the
# port's device flag (get_args_parser); --world_size and --dist_url are
# the reference's torch.distributed flags (parallel/mesh.py).
_COMPAT_NOTICE = {
    "pin_mem": ("--pin-mem", "the Loader has no DataLoader pin_memory knob"),
    "inat_category": ("--inat-category",
                      "parsed but never read by the reference (dead flag)"),
    "resplit": ("--resplit",
                "parsed but never read by the reference (dead flag)"),
}


def add_reference_compat_args(parser):
    parser.add_argument("--device", default=None,
                        help="the device the run uses (default: the card; "
                             "cpu for the CPU)")
    parser.add_argument("--world_size", default=None, type=int,
                        help="processes in the run (the WORLD_SIZE "
                        "environment variable wins, as in the reference)")
    parser.add_argument("--dist_url", default=None,
                        help="the process group's rendezvous, e.g. "
                        "tcp://host:port (default env://: MASTER_ADDR and "
                        "MASTER_PORT)")
    parser.add_argument("--pin-mem", action="store_true", default=None,
                        dest="pin_mem",
                        help="no-op (reference compat; warns if set)")
    parser.add_argument("--no-pin-mem", action="store_false",
                        dest="pin_mem", help="no-op (reference compat)")
    parser.add_argument("--inat-category", default=None,
                        dest="inat_category",
                        help="no-op (dead in the reference too)")
    parser.add_argument("--resplit", action="store_true", default=None,
                        help="no-op (dead in the reference too)")
    parser.add_argument("--model-ema-force-cpu", action="store_true",
                        dest="model_ema_force_cpu",
                        help="unsupported; raises")


def check_reference_compat_args(args):
    if getattr(args, "model_ema_force_cpu", False):
        raise ValueError(
            "--model-ema-force-cpu is unsupported: the EMA lives on the "
            "device and is updated inside the train step (a host-side EMA "
            "would serialize every step through the host)")
    for name, (flag, why) in _COMPAT_NOTICE.items():
        if getattr(args, name, None) is not None:
            print(f"NOTE: {flag} has no effect here: {why}")


def main(argv=None):
    return run_training(parse_args(argv))


if __name__ == "__main__":
    main()
