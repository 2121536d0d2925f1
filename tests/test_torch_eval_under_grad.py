"""Eval-mode forwards under autograd take the plain composition.

The eval kernels (``fused_full_block``, ``fused_block_attention``,
``fused_mlp_residual``, ``fused_mlp_gather_residual``, ATS's
``fused_rect_block``) have no backward: on the card their outputs carry
no gradient. So a block in eval mode whose forward autograd records (grad
mode on and the input or a parameter requiring grad: ``--no-train-mode``
training, JAX's ``train_mode=False``) runs the plain composition, as JAX
forces its XLA composition for such a run (train/loop.py:573-579), and
every ``torch.no_grad()`` eval keeps the kernels. On the CPU every
wrapper runs its plain version, so the route is shown by call recorders
that pass through to the real functions. The models have one head of 64
(the kernels' head dim) so that the width gates let the kernels take
every block.
"""

import collections
import functools

import pytest
import torch

from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.core import layers
from tokenreduction_tpu_torch.reduction import ats as ats_module
from tokenreduction_tpu_torch.train import losses, optim, step
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(device="cpu", num_classes=7, img_size=32, embed_dim=64,
            num_heads=1, depth=4, patch_size=8, reduction_loc=(1, 2),
            keep_rate=(0.7,))
EVAL_KERNELS = {
    layers: ("fused_full_block", "fused_block_attention",
             "fused_mlp_residual", "fused_mlp_gather_residual"),
    ats_module: ("fused_block_attention", "fused_rect_block",
                 "fused_mlp_residual"),
}


@pytest.fixture
def calls(monkeypatch):
    """Calls of every eval kernel entry point, by name."""
    counts = collections.Counter()

    def recorder(name, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return run

    for module, names in EVAL_KERNELS.items():
        for name in names:
            monkeypatch.setattr(module, name,
                                recorder(name, getattr(module, name)))
    return counts


@pytest.mark.parametrize("name", ["topk_small_patch16_224",
                                  "tome_small_patch16_224",
                                  "ats_small_patch16_224",
                                  "deit_small_patch16_224_local"])
def test_eval_forward_under_grad_runs_no_eval_kernel(calls, name):
    model, _ = create_model(name, **TINY)
    model.eval()
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    out = model(x)
    assert sum(calls.values()) == 0, dict(calls)
    out.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    with torch.no_grad():
        again = model(x)
    assert sum(calls.values()) > 0
    torch.testing.assert_close(again, out.detach(), rtol=1e-5, atol=1e-5)


def test_input_requiring_grad_alone_takes_the_plain_route(calls):
    """Frozen parameters and an input that requires grad (a saliency
    map's forward) are a forward that autograd records too."""
    model, _ = create_model("deit_small_patch16_224_local", **TINY)
    model.eval().requires_grad_(False)
    x = torch.zeros(1, 3, 32, 32)
    model(x)
    assert sum(calls.values()) > 0  # nothing requires grad: the kernels
    calls.clear()
    model(x.requires_grad_())
    assert sum(calls.values()) == 0


def test_no_train_mode_step_runs_the_plain_composition(calls):
    """A train step with ``train_mode=False`` (--no-train-mode) launches no
    eval kernel, and its loss is the eval forward's."""
    model, _ = create_model("topk_small_patch16_224", **TINY)
    opt, _ = optim.create_optimizer(dict(model.named_parameters()),
                                    optim.OptimConfig(lr=1e-3),
                                    lambda s: 1e-3, [])
    state = step.init_train_state(model, opt, device="cpu")
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([0, 1, 2, 3])
    with torch.no_grad():
        want = losses.cross_entropy(model.eval()(x), y)
    calls.clear()
    train_step = step.make_train_step(
        model, lambda out, t, i, p: losses.cross_entropy(out, t), opt,
        step.StepConfig(train_mode=False))
    state, metrics = train_step(state, {"image": x, "label": y})
    assert sum(calls.values()) == 0, dict(calls)
    assert not model.training
    torch.testing.assert_close(metrics["loss"], want, rtol=1e-6, atol=1e-6)
    assert float(metrics["grad_norm"]) > 0
