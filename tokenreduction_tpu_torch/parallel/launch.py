"""Start one command on several processes, as torchrun starts them, and
the multi-process dry run (counterpart of ``__graft_entry__.py:63``).

``spawn(world, argv)`` runs ``argv`` once a rank with ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR=localhost`` and a free
``MASTER_PORT`` in its environment, waits for all of them, stops the rest
as soon as one fails or the time is up, and returns each rank's
``RESULT {json}`` line. ``dryrun_multichip(n)`` spawns
``python -m tokenreduction_tpu_torch.parallel.launch dryrun``: one
topk@0.7 data-parallel step (tiny widths at head dim 64, so that the
attention kernels run on the card, mixup, accumulation 2, EMA) on each
rank's card over NCCL, or over gloo on the CPU with ``--device cpu``.

Usage:
  python -c "from tokenreduction_tpu_torch.parallel import \\
      dryrun_multichip; dryrun_multichip(2, device='cpu')"
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

RESULT = "RESULT "


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world: int, argv: list, env: dict = None, timeout: float = 600.0,
          cwd: str = None) -> list:
    """Each rank's last RESULT object (None when it printed none), in
    rank order; raises with the failing ranks' output when a rank exits
    non-zero or the time runs out (every process is stopped first)."""
    port = str(free_port())
    with tempfile.TemporaryDirectory() as tmp:
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world)]
        procs = []
        try:
            for rank in range(world):
                e = dict(os.environ, **(env or {}), RANK=str(rank),
                         LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                         MASTER_ADDR="localhost", MASTER_PORT=port)
                with open(logs[rank], "w") as f:
                    procs.append(subprocess.Popen(
                        argv, env=e, cwd=cwd, stdout=f,
                        stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.poll() for p in procs) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = [open(path).read() for path in logs]
    results, bad = [], []
    for rank, (p, text) in enumerate(zip(procs, texts)):
        lines = [ln for ln in text.splitlines() if ln.startswith(RESULT)]
        if p.returncode:
            bad.append(f"rank {rank} exit {p.returncode}:\n{text[-4000:]}")
        results.append(json.loads(lines[-1][len(RESULT):]) if lines
                       else None)
    if bad:
        raise RuntimeError(f"{len(bad)} of {world} ranks failed:\n"
                           + "\n".join(bad))
    return results


def dryrun_multichip(n: int, device=None, timeout: float = 600.0) -> None:
    """One data-parallel step on ``n`` processes; raises unless every rank
    exits 0 with the same finite loss."""
    import math

    argv = [sys.executable, "-m", "tokenreduction_tpu_torch.parallel.launch",
            "dryrun"] + (["--device", "cpu"] if device == "cpu" else [])
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {"PYTHONPATH": os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    results = spawn(n, argv, env=env, timeout=timeout)
    if None in results:
        raise RuntimeError(f"dryrun_multichip({n}): a rank printed no "
                           f"result: {results}")
    losses = {r["loss"] for r in results}
    if len(losses) != 1 or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"dryrun_multichip({n}): {results}")
    where = "cpu (gloo)" if device == "cpu" else "cuda (nccl)"
    print(f"dryrun_multichip({n}): ok on {where}, loss={results[0]['loss']}")


def _dryrun(device) -> dict:
    import torch

    from tokenreduction_tpu_torch import create_model
    from tokenreduction_tpu_torch.parallel.mesh import (
        DataParallel,
        init_distributed,
    )
    from tokenreduction_tpu_torch.train import losses
    from tokenreduction_tpu_torch.train.mixup import (
        MixupConfig,
        make_mixup_fn,
    )
    from tokenreduction_tpu_torch.train.optim import (
        OptimConfig,
        create_optimizer,
    )
    from tokenreduction_tpu_torch.train.step import (
        StepConfig,
        init_train_state,
        make_train_step,
    )

    info = init_distributed(device)
    dev = info["device"] or torch.device(device or "cuda")
    model, _ = create_model(
        "topk_small_patch16_224", num_classes=11, img_size=32, embed_dim=64,
        num_heads=1, depth=6, patch_size=8, reduction_loc=(1, 3),
        keep_rate=(0.7,), device=dev,
        generator=torch.Generator().manual_seed(0))
    opt, _ = create_optimizer(
        dict(model.named_parameters()),
        OptimConfig(lr=1e-3, clip_grad=1.0, backbone_lr_scale=0.01),
        lambda s: 1e-3, [], steps_per_epoch=10)
    dp = DataParallel()
    state = init_train_state(model, opt, ema=True, device=dev, dp=dp)
    step = make_train_step(
        model, lambda out, t, i, p: losses.soft_target_ce(out, t), opt,
        StepConfig(grad_accum_steps=2, ema_decay=0.999),
        torch.Generator(device=dev).manual_seed(3),
        make_mixup_fn(MixupConfig(num_classes=11), seed=3), dp=dp)
    g = torch.Generator().manual_seed(1 + dp.rank)
    batch = {"image": torch.randn(4, 3, 32, 32, generator=g).to(dev),
             "label": torch.randint(0, 11, (4,), generator=g).to(dev)}
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    if info["initialized"]:
        import torch.distributed as dist

        dist.destroy_process_group()
    return {"rank": dp.rank, "world": dp.world, "loss": loss}


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser("tokenreduction_tpu_torch.parallel")
    parser.add_argument("job", choices=["dryrun"])
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    print(RESULT + json.dumps(_dryrun(args.device)), flush=True)


if __name__ == "__main__":
    main()
