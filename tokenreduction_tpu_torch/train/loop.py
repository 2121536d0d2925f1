"""The training loop (counterpart of ``tokenreduction_tpu/train/loop.py``;
reference train.py:240-719 and engine.py).

``build_base_criterion`` and ``build_loss_fn`` read the same argparse
fields as the JAX functions (``smoothing``, ``bce_loss``,
``ratio_weight``, ``cls_distill_weight``, ``token_distill_weight``,
``cls_weight``, ``mse_token``, ``dyvit_distill``, ``distillation_type``,
``distillation_alpha``, ``distillation_tau``) and build the same
``loss_fn(out, targets, images, params)``: DyViT's keep-ratio loss, with
``dyvit_distill`` its distillation against the dense teacher; DeiT's
distillation (soft or hard) against any teacher; else the base criterion
of the logits. ``make_teacher_apply`` runs a teacher as JAX's
``teacher_apply``: under ``torch.no_grad()``, in eval mode, in its own
fp32 parameters, on the images the step was given before any amp cast.

``run_training`` is the epoch loop of the train CLI
(``train/train_cli.py``) on one device: the data pipeline's Loader
(``RASampler``, or ``ShardedSampler`` under ``--no-repeated-aug``), with
``--device_aug`` the uint8 squares that the augmentation on the card takes
(``data/device_aug.py``, JAX loop.py:273-319; ThreeAugment and ``--src``
fall back to the host transforms, as in JAX), the model from the registry
with ``--finetune`` (a timm ``.pth`` or a Brain-Flax ``.npz``), the
teachers, the linear LR scaling, the schedule (lr noise included; the
plateau decay applied on the host to the optimizer's learning rates, its
state kept, JAX loop.py:782-800), the grouped optimizer (``--opt``;
AdaHessian pins the plain composition for the whole run, as JAX forces
XLA), mixup/cutmix, the train step (``--wandb_watch``: each module's
norms in the log rows),
the eval of the params and of the EMA after each epoch (the better one
kept), ``best_checkpoint`` and ``checkpoint`` through the
``AsyncCheckpointer``, ``--resume``, ``--eval`` and the ``log.txt`` rows
with JAX's keys. Its randomness: one ``torch.Generator`` on the model's
device seeded from ``--seed`` (drop-path, dropout, DyViT's Gumbel draw,
DPC-KNN's noise, equal-weight k-medoids' first medoid) and mixup's host
``numpy.random.Generator`` from the same seed; a resumed run restarts
both from the seed, as JAX restarts ``PRNGKey(seed)``. The eval in the
loop passes no generator (JAX passes no RNG: DPC-KNN draws no noise),
except to equal-weight k-medoids, whose eval needs its first medoid: a
generator seeded from ``--seed`` anew for each eval. The host reads the
step's loss every ``--print-freq`` steps and at the end of an epoch, not
after each step.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tokenreduction_tpu_torch.core.config import expand_keep_rate
from tokenreduction_tpu_torch.evaluation.validate import (
    eval_device,
    set_fp32_products,
)
from tokenreduction_tpu_torch.models import convert as C
from tokenreduction_tpu_torch.models.registry import create_model
from tokenreduction_tpu_torch.train import losses as L
from tokenreduction_tpu_torch.train.mixup import (
    MixupConfig,
    make_mixup_fn,
    multilabel_passthrough,
)
from tokenreduction_tpu_torch.train.optim import OptimConfig, create_optimizer
from tokenreduction_tpu_torch.train.scheduler import SchedConfig, make_schedule
from tokenreduction_tpu_torch.train.step import (
    StepConfig,
    init_train_state,
    make_eval_step,
    make_train_step,
)
from tokenreduction_tpu_torch.utils.checkpoint import (
    AsyncCheckpointer,
    load_checkpoint,
    restore_train_state,
)
from tokenreduction_tpu_torch.utils.metrics import (
    JSONLLogger,
    MetricLogger,
    mAP,
)


def build_base_criterion(args, multilabel: bool, mixup_on: bool):
    if multilabel:
        def crit(logits, targets):
            return L.asymmetric_multilabel_loss(logits.float(), targets)
        return crit
    if mixup_on:
        return L.soft_target_ce
    if getattr(args, "bce_loss", False):
        def bce(logits, targets):
            onehot = F.one_hot(targets, logits.shape[-1]).float()
            return L.bce_with_logits(logits, onehot)
        return bce
    if getattr(args, "smoothing", 0.0):
        def smooth(logits, targets):
            return L.label_smoothing_ce(logits, targets, args.smoothing)
        return smooth
    return L.cross_entropy


def make_teacher_apply(teacher: torch.nn.Module) -> Callable:
    """``teacher_apply(images)``: the teacher's output on the uncast images,
    with no gradient and in eval mode. The teacher keeps its own fp32
    parameters (it is not the state the step casts under amp)."""
    teacher.eval()

    def teacher_apply(images):
        with torch.no_grad():
            return teacher(images)

    return teacher_apply


def build_loss_fn(args, model_cfg, base_crit,
                  teacher_apply: Optional[Callable] = None):
    """The final ``loss(out, targets, images, params)`` with the
    distillation wrappers (reference train.py:507-513). ``images`` are
    the step's images before its amp cast, which the teacher reads.
    Refuses ``train_mode=False`` (--no-train-mode) with DyViT or with DeiT
    distillation: the eval forward returns bare (or dist-averaged)
    logits, and these losses need the training outputs (JAX
    train/loop.py:565-572; the reference fails the same way, train.py:599
    with losses.py:31, :90)."""
    method = model_cfg.method
    dyvit_distill = bool(getattr(args, "dyvit_distill", False)) and \
        method == "dyvit"
    deit_type = getattr(args, "distillation_type", "none")
    if not getattr(args, "train_mode", True) and (
            method == "dyvit" or deit_type != "none"):
        raise ValueError("--no-train-mode is incompatible with dyvit "
                         "and with --distillation-type != none")

    if method == "dyvit":
        keep_rate = expand_keep_rate(model_cfg)

        def dyvit_loss(out, targets, images, params):
            if dyvit_distill:
                logits, feats, mask, scores = out
                tcls, ttok = (teacher_apply(images)
                              if teacher_apply else (None, None))
                return L.dyvit_distillation_loss(
                    base_crit(logits, targets), logits, feats, mask, scores,
                    keep_rate, tcls, ttok,
                    ratio_weight=args.ratio_weight,
                    cls_distill_weight=args.cls_distill_weight,
                    token_distill_weight=args.token_distill_weight,
                    cls_weight=args.cls_weight, mse_token=args.mse_token)
            logits, scores = out
            ratio = 0.0
            for i, s in enumerate(scores):
                ratio = ratio + torch.mean((s.mean(dim=1) - keep_rate[i]) ** 2)
            return base_crit(logits, targets) + \
                (ratio / max(len(scores), 1)) * args.ratio_weight

        return dyvit_loss

    if deit_type != "none" and teacher_apply is not None:

        def deit_loss(out, targets, images, params):
            logits, logits_kd = out if isinstance(out, tuple) else (out, out)
            tlogits = teacher_apply(images)
            if isinstance(tlogits, tuple):
                tlogits = tlogits[0]
            return L.deit_distillation_loss(
                base_crit(logits, targets), logits_kd, tlogits, deit_type,
                args.distillation_alpha, args.distillation_tau)

        return deit_loss

    def loss_fn(out, targets, images, params):
        logits = out[0] if isinstance(out, tuple) else out
        return base_crit(logits, targets)

    return loss_fn


def images_to_device(image: np.ndarray, device) -> torch.Tensor:
    """A Loader batch's HWC float32 images as an NCHW tensor on
    ``device`` (copied without waiting for the card); uint8 squares (the
    device augmentation's input) are copied as they are, uint8 HWC, and
    the augmentation casts them on the card."""
    x = torch.from_numpy(image).to(device, non_blocking=True)
    if x.dtype == torch.uint8:
        return x
    return x.permute(0, 3, 1, 2).contiguous()


def labels_to_device(label: np.ndarray, device) -> torch.Tensor:
    """Class ids as int64 (the losses' gather index), multilabel targets
    as they are."""
    t = torch.from_numpy(label)
    if not t.is_floating_point():
        t = t.long()
    return t.to(device, non_blocking=True)


def evaluate(eval_step, params, loader, device, multilabel: bool):
    """engine.py:119-205 equivalent on one device: top-1/top-5 and the
    mean cross-entropy over the real rows (the Loader's pads carry weight
    0), or the multilabel mAP in both accuracies. The sums stay on the
    device until the last batch (float64), then one read."""
    if multilabel:
        preds, targs = [], []
        for batch in loader:
            valid = batch.pop("valid", len(batch["image"]))
            t = batch["label"]
            if t.ndim == 3:
                t = t.max(axis=1)
            p, tt = eval_step(params, {
                "image": images_to_device(batch["image"], device),
                "label": labels_to_device(t, device)})
            preds.append(p[:valid])
            targs.append(tt[:valid])
        score = mAP(torch.cat(targs).cpu().numpy(),
                    torch.cat(preds).cpu().numpy())
        return {"acc1": score, "acc5": score, "loss": 0.0}
    tot = None
    for batch in loader:
        valid = batch.pop("valid", len(batch["image"]))
        w = np.zeros((len(batch["image"]),), np.float32)
        w[:valid] = 1.0
        m = eval_step(params, {
            "image": images_to_device(batch["image"], device),
            "label": labels_to_device(batch["label"], device),
            "weight": torch.from_numpy(w).to(device, non_blocking=True)})
        m = {k: v.double() for k, v in m.items()}
        tot = m if tot is None else {k: tot[k] + m[k] for k in tot}
    tot = {k: float(v) for k, v in tot.items()} if tot else \
        dict.fromkeys(("correct1", "correct5", "loss_sum", "count"), 0.0)
    n = max(tot["count"], 1)
    return {"acc1": 100.0 * tot["correct1"] / n,
            "acc5": 100.0 * tot["correct5"] / n,
            "loss": tot["loss_sum"] / n}


def _load_finetune(args, model, model_cfg):
    """--finetune: a timm .pth, or a Brain-Flax ViT .npz through its Flax
    tree (JAX loop.py:385-404), merged strict=False, pos_embed resized to
    the model's grid; prints the report."""
    if args.finetune.endswith(".npz"):
        flax_tree, _ = C.convert_jax_npz(C.load_jax_npz_state(args.finetune))
        tree = C.state_dict_from_flax(flax_tree)
    else:
        tree, _ = C.convert_torch_state_dict(
            C.load_torch_checkpoint(args.finetune))
    if "pos_embed" in tree:
        # interpolate to the target grid (reference train.py:336-370)
        tree["pos_embed"] = torch.from_numpy(C.resize_pos_embed(
            tree["pos_embed"].numpy(), model_cfg.num_patches,
            model_cfg.num_prefix_tokens))
    merged, report = C.merge_pretrained(model.state_dict(), tree)
    model.load_state_dict(merged, strict=True)
    print(f"finetune load: {len(report['loaded'])} loaded, "
          f"{len(report['shape_mismatch'])} mismatched")
    return report


def _build_teacher(args, num_classes, dim_kw, device):
    """The DeiT distillation teacher (reference train.py:455-478) from the
    registry, its weights from --teacher-path: a torch .pth (timm names)
    or a port checkpoint directory (EMA params when they were best)."""
    is_convnet = args.teacher_model.startswith("regnet")
    kw = dim_kw
    if is_convnet:
        kw = {}
        for k in ("depths", "widths", "group_width", "stem_width"):
            v = getattr(args, f"teacher_regnet_{k}", None)
            if v is not None:
                kw[k] = v
    teacher, _ = create_model(
        args.teacher_model, num_classes=num_classes,
        img_size=args.input_size, device=device,
        generator=torch.Generator().manual_seed(0), **kw)
    path = args.teacher_path
    torch_suffixes = (".pth", ".pt", ".bin", ".tar")
    if path and path.endswith(torch_suffixes):
        conv = (C.convert_regnet_state_dict if is_convnet
                else C.convert_torch_state_dict)
        tree, _ = conv(C.load_torch_checkpoint(path))
        merged, report = C.merge_pretrained(teacher.state_dict(), tree)
        teacher.load_state_dict(merged, strict=True)
        print(f"teacher load ({path}): {len(report['loaded'])} loaded, "
              f"{len(report['shape_mismatch'])} mismatched")
    elif path:
        if os.path.isfile(path):
            raise ValueError(
                f"--teacher-path {path}: single files must be torch "
                f"checkpoints ({'/'.join(torch_suffixes)}); directories are "
                "read as the port's checkpoints")
        tree, meta = load_checkpoint(path)
        teacher.load_state_dict(
            tree["ema_params"] if meta.get("ema_best")
            and tree.get("ema_params") is not None else tree["params"],
            strict=True)
    return make_teacher_apply(teacher)


def device_aug_setup(args, tcfg, ds_train, ds_val, multilabel: bool):
    """(aug_fn, train transform, eval transform on the card, val
    transform) of ``--device_aug`` (JAX loop.py:273-319): the Loader
    copies uint8 squares (a cached set's own size, else
    int(input_size / crop_pct + 0.5)) and the step augments them on the
    card; a cached val set is transformed on the card too. Without the
    flag, or with ThreeAugment or ``--src`` (the host recipe only), the
    host transforms and no aug."""
    from tokenreduction_tpu_torch.data import make_transform
    from tokenreduction_tpu_torch.data.pipeline import make_raw_transform

    host = (None, make_transform(args.dataset, True, tcfg), None,
            make_transform(args.dataset, False, tcfg))
    if not args.device_aug:
        return host
    if tcfg.three_augment or tcfg.src_crop:
        print("device_aug: unsupported recipe (ThreeAugment/src); "
              "falling back to host transforms")
        return host
    from tokenreduction_tpu_torch.data.device_aug import (
        DeviceAugConfig,
        make_device_augment,
        make_device_eval_transform,
    )
    aug_cfg = DeviceAugConfig(
        input_size=args.input_size,
        recipe="asl" if multilabel else "imagenet",
        aa=tcfg.aa if args.dataset != "nabirds" else "",
        color_jitter=tcfg.color_jitter, reprob=tcfg.reprob,
        recount=tcfg.recount)
    images = getattr(ds_train, "images", None)
    raw_size = (int(images.shape[1]) if images is not None
                else int(args.input_size / tcfg.crop_pct + 0.5))
    eval_tf, val_transform = host[2], host[3]
    if getattr(ds_val, "images", None) is not None:
        eval_tf = make_device_eval_transform(aug_cfg)
        val_transform = make_raw_transform(int(ds_val.images.shape[1]))
    return (make_device_augment(aug_cfg), make_raw_transform(raw_size),
            eval_tf, val_transform)


def run_training(args):
    """The train CLI's run (see the module docstring); returns
    {"max_accuracy"} (with --eval, the eval's stats)."""
    # imported here: the data path needs Pillow, which the rest of the
    # port (and chip_smoke.py's runs without it) does not
    from tokenreduction_tpu_torch.data import (
        Loader,
        RASampler,
        ShardedSampler,
        TransformConfig,
        build_dataset,
    )

    device = eval_device(args)
    set_fp32_products(args.use_amp)

    # ----- data
    tcfg = TransformConfig(
        input_size=args.input_size, color_jitter=args.color_jitter,
        aa=args.aa, train_interpolation=args.train_interpolation,
        reprob=args.reprob, remode=args.remode, recount=args.recount,
        three_augment=getattr(args, "ThreeAugment", False),
        src_crop=getattr(args, "src", False))
    ds_train, num_classes = build_dataset(
        args.data, args.dataset, "train", num_classes=args.synthetic_classes,
        img_size=args.input_size, synthetic_n=args.synthetic_n)
    ds_val, _ = build_dataset(
        args.data, args.dataset, "val", num_classes=args.synthetic_classes,
        img_size=args.input_size, synthetic_n=args.synthetic_n)
    multilabel = getattr(ds_train, "multilabel", False)
    host_batch = args.batch_size * args.grad_accum_steps
    sampler = (RASampler if args.repeated_aug else ShardedSampler)(
        len(ds_train), 1, 0, seed=args.seed)
    aug_fn, train_transform, eval_tf, val_transform = device_aug_setup(
        args, tcfg, ds_train, ds_val, multilabel)
    train_loader = Loader(
        ds_train, sampler, host_batch, train_transform, drop_last=True,
        seed=args.seed, num_workers=args.num_workers)
    if len(train_loader) == 0:
        # reference-faithful but easy to hit on tiny datasets: RASampler
        # truncates the epoch to floor(n//256*256/world) samples
        # (reference samplers.py:40)
        print(f"WARNING: train loader is empty (dataset {len(ds_train)}, "
              f"host batch {host_batch}, "
              f"repeated_aug={bool(args.repeated_aug)}); every epoch "
              "will train 0 steps. Use --no-repeated-aug and/or a "
              "smaller --batch-size for tiny datasets.")
    val_loader = Loader(
        ds_val, ShardedSampler(len(ds_val), 1, 0, shuffle=False),
        args.batch_size, val_transform,
        seed=args.seed, pad_partial=True, num_workers=args.num_workers)
    steps_per_epoch = max(len(train_loader), 1)

    # ----- model
    model_kw = {}
    for k in ("k_neighbors", "cluster_iters", "equal_weight", "sinkhorn_eps",
              "heuristic_pattern", "min_radius", "not_contiguous"):
        if hasattr(args, k):
            model_kw[k] = getattr(args, k)
    dim_kw = {k: getattr(args, k) for k in ("embed_dim", "depth",
                                            "num_heads", "patch_size")
              if getattr(args, k, None) is not None}
    deit_distillation = args.distillation_type != "none"
    model, model_cfg = create_model(
        args.model, num_classes=num_classes, img_size=args.input_size,
        reduction_loc=tuple(args.reduction_loc),
        keep_rate=tuple(args.keep_rate),
        drop_rate=args.drop, drop_path_rate=args.drop_path,
        dyvit_distillation=bool(getattr(args, "dyvit_distill", False)),
        # DeiT's distillation token only exists on the dense backbone
        # (reference models_act.py:69-78; reduction models ignore it)
        distilled=deit_distillation and "deit" in args.model,
        device=device, generator=torch.Generator().manual_seed(args.seed),
        **model_kw, **dim_kw)
    if args.finetune:
        _load_finetune(args, model, model_cfg)
    hutchinson = args.opt.lower() == "adahessian"
    if hutchinson:
        # make_train_step pins it: the kernels' autograd.Functions have no
        # double backward (JAX loop.py:554-562 forces its XLA path)
        print("adahessian: the plain composition pinned for the whole run "
              "(the kernels have no double backward)")

    # ----- teachers
    teacher_apply = None
    if deit_distillation:
        teacher_apply = _build_teacher(args, num_classes, dim_kw, device)
    if model_cfg.method == "dyvit" and getattr(args, "dyvit_distill", False) \
            and not getattr(args, "no_dyvit_teacher", False):
        teacher, _ = create_model(
            args.model + "_teacher", num_classes=num_classes,
            img_size=args.input_size, device=device,
            generator=torch.Generator().manual_seed(0), **dim_kw)
        if getattr(args, "dyvit_teacher_weights", ""):
            tree, _ = load_checkpoint(args.dyvit_teacher_weights)
            teacher.load_state_dict(tree["params"], strict=True)
        teacher_apply = make_teacher_apply(teacher)

    # ----- optimizer (linear LR scaling, reference train.py:416-419)
    if not args.unscale_lr:
        args.lr = args.lr * host_batch / args.lr_batch_normalizer
    scfg = SchedConfig(
        sched=args.sched, lr=args.lr, min_lr=args.min_lr,
        warmup_lr=args.warmup_lr, warmup_epochs=args.warmup_epochs,
        epochs=args.epochs, cooldown_epochs=args.cooldown_epochs,
        decay_epochs=args.decay_epochs, decay_rate=args.decay_rate,
        sched_in_steps=args.sched_in_steps,
        steps_per_epoch=steps_per_epoch,
        lr_noise=tuple(args.lr_noise) if args.lr_noise else None,
        lr_noise_pct=args.lr_noise_pct, lr_noise_std=args.lr_noise_std,
        seed=args.seed)
    sched_host = make_schedule(scfg)

    def base_schedule(step):
        return sched_host(step if scfg.sched_in_steps
                          else step // steps_per_epoch)

    ocfg = OptimConfig(
        opt=args.opt, lr=args.lr, weight_decay=args.weight_decay,
        momentum=args.momentum, opt_eps=args.opt_eps,
        opt_betas=tuple(args.opt_betas) if args.opt_betas else None,
        clip_grad=args.clip_grad,
        backbone_lr_scale=args.backbone_lr_scale,
        backbone_freeze_steps=args.backbone_freeze_steps,
        # the reference's alias (JAX loop.py:517): --constant_cls freezes
        # pos_embed too, and --constant_pos alone freezes nothing
        constant_cls=args.constant_cls, constant_pos=args.constant_cls,
        attn_only=getattr(args, "attn_only", False))
    new_names = getattr(type(model), "new_module_names", lambda: [])()
    optimizer, _ = create_optimizer(dict(model.named_parameters()), ocfg,
                                    base_schedule, new_names,
                                    steps_per_epoch)

    # ----- loss and steps
    mixup_on = (not multilabel) and (
        args.mixup > 0 or args.cutmix > 0 or args.cutmix_minmax is not None)
    loss_fn = build_loss_fn(args, model_cfg,
                            build_base_criterion(args, multilabel, mixup_on),
                            teacher_apply)
    mixup_fn = None
    if mixup_on:
        mixup_fn = make_mixup_fn(MixupConfig(
            mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
            prob=args.mixup_prob, switch_prob=args.mixup_switch_prob,
            label_smoothing=args.smoothing, num_classes=num_classes,
            mode=args.mixup_mode,
            cutmix_minmax=(tuple(args.cutmix_minmax)
                           if args.cutmix_minmax else None)), args.seed)
    if multilabel:
        mixup_fn = multilabel_passthrough
    if not args.train_mode:
        print("--no-train-mode: the training forward runs in eval mode; "
              "its blocks take the plain composition under autograd (the "
              "eval kernels have no backward)")
    if args.steps_per_call > 1:
        print(f"NOTE: --steps_per_call {args.steps_per_call} fuses steps "
              "into one XLA call in JAX; here the steps run one by one "
              "(the same arithmetic)")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    train_step = make_train_step(
        model, loss_fn, optimizer,
        StepConfig(grad_accum_steps=args.grad_accum_steps,
                   ema_decay=args.model_ema_decay if args.model_ema else 0.0,
                   amp=args.use_amp, train_mode=args.train_mode,
                   project_sinkhorn=model_cfg.method == "sinkhorn",
                   watch_norms=args.wandb_watch, hutchinson=hutchinson),
        generator, mixup_fn, aug_fn)
    # equal-weight k-medoids draws its first medoids in eval too
    eval_gen = (torch.Generator(device=device)
                if model_cfg.method == "kmedoids" and model_cfg.equal_weight
                else None)
    eval_step = make_eval_step(model, multilabel, eval_gen, eval_tf)

    def run_eval(params):
        if eval_gen is not None:
            eval_gen.manual_seed(args.seed)
        return evaluate(eval_step, params, val_loader, device, multilabel)

    state = init_train_state(model, optimizer, ema=args.model_ema,
                             device=device)

    start_epoch = args.start_epoch
    if args.resume:
        tree, meta = load_checkpoint(args.resume)
        state = restore_train_state(state, tree, meta)
        start_epoch = meta["epoch"] + 1

    logger = JSONLLogger(
        os.path.join(args.output_dir, "log.txt") if args.output_dir
        else None, use_wandb=args.wandb,
        wandb_kwargs=dict(project=args.wandb_project, group=args.wandb_group))
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)

    if args.eval:
        stats = run_eval(state.params)
        print(f"Eval: {stats}")
        return stats

    # -1 so the first epoch always writes a best checkpoint, even at 0.0
    # accuracy (the reference's `0.0 > 0.0` gate would save nothing)
    max_accuracy = -1.0
    ema_best = False
    total_step = state.step
    # ReduceLROnPlateau on the host (JAX loop.py:682-800): the decay scales
    # the optimizer's learning rates and keeps its state
    plateau_scale, plateau_best, plateau_wait = 1.0, -1.0, 0
    metrics = {}
    ckptr = AsyncCheckpointer()
    run_args = {k: v for k, v in vars(args).items() if not callable(v)}
    for epoch in range(start_epoch, args.epochs):
        train_loader.set_epoch(epoch)
        meter = MetricLogger()
        t_ep = time.time()
        n_img = 0
        prof = None
        if args.profile_dir and epoch == start_epoch:
            prof = _start_profile(device)
        pending = []
        for i, batch in enumerate(meter.log_every(train_loader,
                                                  args.print_freq,
                                                  f"Epoch [{epoch}]")):
            b = {"image": images_to_device(batch["image"], device),
                 "label": labels_to_device(batch["label"], device)}
            state, metrics = train_step(state, b)
            total_step += 1
            n_img += len(batch["image"])
            pending.append(metrics["loss"])
            if args.print_freq and i % args.print_freq == 0:
                for loss in pending:  # the host reads the losses here
                    meter.update(loss=float(loss))
                pending = []
        for loss in pending:
            meter.update(loss=float(loss))
        if prof is not None:
            _stop_profile(prof, args.profile_dir)
        epoch_time = time.time() - t_ep
        ips = n_img / epoch_time

        test_stats = run_eval(state.params)
        cur, cur_is_ema = test_stats["acc1"], False
        if state.ema_params is not None:
            ema_stats = run_eval(state.ema_params)
            if ema_stats["acc1"] > cur:
                cur, cur_is_ema = ema_stats["acc1"], True
        save = dict(params=state.params, ema_params=state.ema_params,
                    opt_state=state.opt_state, epoch=epoch,
                    step=total_step, model_cfg=model_cfg, run_args=run_args)
        if cur > max_accuracy:
            max_accuracy = max(cur, 0.0)
            ema_best = cur_is_ema
            if args.output_dir:
                ckptr.save(os.path.join(args.output_dir, "best_checkpoint"),
                           ema_best=ema_best, max_accuracy=max_accuracy,
                           **save)
        if args.save_more_than_best and args.output_dir:
            ckptr.save(os.path.join(args.output_dir, "checkpoint"),
                       ema_best=ema_best, max_accuracy=max_accuracy, **save)
        if args.sched == "plateau":
            if cur > plateau_best + 1e-9:
                plateau_best, plateau_wait = cur, 0
            else:
                plateau_wait += 1
                if plateau_wait >= args.patience_epochs:
                    plateau_wait = 0
                    plateau_scale *= args.decay_rate
                    optimizer.lr_scale = plateau_scale
                    print(f"plateau: lr scale -> {plateau_scale}")
        lr_now = plateau_scale * sched_host(
            total_step if scfg.sched_in_steps else epoch + 1)
        # wandb.watch's equivalent: the last step's per-module norms
        watch_stats = {k: float(v) for k, v in metrics.items() if "/" in k} \
            if args.wandb_watch else {}
        log_stats = {
            "epoch": epoch, "train_loss": meter.meters["loss"].global_avg,
            "test_acc1": test_stats["acc1"], "test_acc5": test_stats["acc5"],
            "test_loss": test_stats["loss"], "max_accuracy": max_accuracy,
            **watch_stats, "lr": lr_now, "images_per_sec": ips,
            "epoch_time": epoch_time,
        }
        print(json.dumps(log_stats))
        logger.log(log_stats, step=total_step)
    ckptr.wait()  # flush the write in flight
    return {"max_accuracy": max_accuracy}


def _start_profile(device):
    """A torch.profiler window over the first epoch (--profile_dir): the
    host's ops and, on the card, its kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")
