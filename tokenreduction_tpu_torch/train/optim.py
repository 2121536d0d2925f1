"""Grouped optimizers with the reference's 4-way param grouping
(counterpart of tokenreduction_tpu/train/optim.py; reference
optim.py:39-100, 123-227).

Groups:
  new_param / new_param_no_decay : head, pos_embed, patch_embed + the
      model's `new_module_names()` -- full LR, never frozen
  decay / no_decay               : backbone -- LR x backbone_lr_scale,
      LR forced to 0 while epoch < backbone_freeze_steps
      (reference engine.py:35-37)
constant_cls / constant_pos / attn_only freeze params entirely
(label "frozen": no update).

Every name of the JAX package's ``_base_opt`` (optim.py:266-332 there),
each written here by hand with optax 0.2.6's arithmetic, the reference:
``sgd``/``nesterov`` and ``momentum`` (``optax.sgd``), ``adam``,
``adamw``, ``adabelief``, ``nadam``, ``radam`` (each with
``add_decayed_weights`` ahead of it where the JAX chain has one),
``adadelta``, ``adafactor``, ``rmsprop``/``rmsproptf``,
``novograd``/``nvnovograd``, the JAX package's own ``adamp`` and ``sgdp``
(optim.py:118-193 there), ``adahessian`` (optim.py:196-263 there: the
Hutchinson diagonal given at update time, ``hessian_diag=``) and
``lookahead_<name>`` (sync period 5, slow step 0.5). The chain is JAX's:
``clip_by_global_norm`` (g * max / |g| only when |g| >= max; unlike
``torch.nn.utils.clip_grad_norm_`` nothing is added to the norm), then
each group's rule with its own learning rate and weight decay, the
learning rate of update t taken from schedule(t) with t counted from 0.

optax sees Flax kernels [in, out] and [kh, kw, in, out]; the port holds
torch's [out, in] and [out, in, kh, kw]. The rules that look at a
tensor's axes read them in Flax's order through ``flax_axes``: AdamP's and
SGDP's channels are Flax's last axis (the output units, torch dim 0), and
Adafactor factors the two largest Flax axes of at least 128.

``lookahead_<name>`` follows ``optax.lookahead`` given
``LookaheadParams``: the slow weights live in the optimizer state
(``opt_state["slow"]``), the train state's params are the fast ones. The
JAX package's own ``lookahead_*`` raises at its first update (it hands
``optax.lookahead`` plain params inside ``optax.multi_transform``);
README's "Fidelity" records the repair.

Params are the names of ``model.named_parameters()``; the update works in
place on the fp32 masters and the state, which is {part: {name: tensor}}
(what ``utils/checkpoint.py`` saves and ``restore_train_state`` puts
back), and never synchronises with the host: the learning rates, bias
corrections and lookahead's sync are host values of the step count, the
clip factor and AdamP's data-dependent projection stay on the device.

Under FSDP (``parallel/mesh.py``) each rank updates its shards: the
update takes ``shards`` ({name: LeafShard} of the leaves split over the
ranks), and every reduction over a whole tensor sums its partial sums
over the ranks explicitly (``complete_sums``, ``LeafShard.sum_``): the
global norm, NovoGrad's layer norms, AdamP's and SGDP's channel and layer
projections, Adafactor's factored moments and RMS, the Sinkhorn
projection. A leaf held whole takes the single-device arithmetic as it
is, so a world of one is bit-equal to it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from tokenreduction_tpu_torch.parallel.mesh import complete_sums


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    opt: str = "adamw"
    lr: float = 5e-4
    weight_decay: float = 0.05
    momentum: float = 0.9
    opt_eps: float = 1e-8
    opt_betas: Optional[tuple] = None
    clip_grad: Optional[float] = None
    backbone_lr_scale: float = 1.0
    backbone_freeze_steps: int = 0  # epochs, despite the name (reference)
    constant_cls: bool = False
    constant_pos: bool = False
    # reference train.py:372-392 --attn-only: freeze every param except
    # the blocks' attention modules, the classifier head (head.weight /
    # head.bias only -- head_dist stays frozen), and pos_embed
    attn_only: bool = False


BASE_NEW_NAMES = ["head", "head_dist", "pos_embed", "patch_embed"]
GROUPS = ("new_param", "new_param_no_decay", "decay", "no_decay")


def label_for_path(path: Sequence[str], param, new_names: List[str],
                   cfg: OptimConfig) -> str:
    name = ".".join(path)
    if cfg.constant_cls and ("cls_token" in name or "dist_token" in name):
        return "frozen"
    if cfg.constant_pos and "pos_embed" in name:
        return "frozen"
    if cfg.attn_only and ".attn." not in name \
            and not name.startswith("head.") and "pos_embed" not in name:
        return "frozen"
    is_new = any(n in name for n in new_names)
    no_decay = param.ndim <= 1 or path[-1] == "bias"
    if is_new:
        return "new_param_no_decay" if no_decay else "new_param"
    return "no_decay" if no_decay else "decay"


def param_labels(params: Mapping[str, torch.Tensor],
                 new_module_names: List[str], cfg: OptimConfig):
    """{param name: group label}."""
    new_names = BASE_NEW_NAMES + list(new_module_names)
    return {name: label_for_path(tuple(name.split(".")), p, new_names, cfg)
            for name, p in params.items()}


def group_lr_fn(base_schedule: Callable[[int], float], scale: float,
                freeze_epochs: int, steps_per_epoch: int):
    """Per-group LR as a function of the optimizer step counter."""

    def lr(step: int) -> float:
        t = base_schedule(step)
        if freeze_epochs > 0 and step // max(steps_per_epoch, 1) < \
                freeze_epochs:
            t = 0.0
        return t * scale

    return lr


def global_norm(tensors, shards: Optional[list] = None) -> torch.Tensor:
    """sqrt(sum of squares) over every element of every tensor, on the
    device. ``shards``: each tensor's LeafShard when it is a shard of a
    split leaf (None when whole); the shards' norms are completed over the
    ranks (sqrt of the summed squares) before the global one."""
    norms = torch._foreach_norm(list(tensors))
    if shards is not None and any(s is not None for s in shards):
        sq = complete_sums([n * n for n in norms], shards)
        norms = [torch.sqrt(q) if sh is not None else n
                 for n, q, sh in zip(norms, sq, shards)]
    return torch.linalg.vector_norm(torch.stack(norms))


def flax_axes(name: str, ndim: int) -> tuple:
    """The torch axis of each axis of the Flax layout, in Flax's order:
    a Dense kernel [in, out] is the 2-d ``.weight`` [out, in] -> (1, 0); a
    conv kernel [kh, kw, in, out] the 4-d ``.weight`` [out, in, kh, kw] ->
    (2, 3, 1, 0) (``models/convert.py``); any other leaf keeps its
    layout."""
    if name.endswith(".weight") and ndim == 2:
        return (1, 0)
    if name.endswith(".weight") and ndim == 4:
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def _f32(x) -> float:
    return float(np.float32(x))


def _bias_correction(b: float, t: int) -> float:
    """optax's 1 - b**t in fp32."""
    f32 = np.float32
    return float(f32(1.0) - f32(b) ** f32(t))


class Leaves:
    """What a rule sees of one group: the names, params, grads, state
    lists and each leaf's Flax axes."""

    def __init__(self, names, params, grads, state, axes, shards=None):
        self.names = names
        shards = shards or {}
        self.shards = [shards.get(n) for n in names]
        self.p = [params[n] for n in names]
        self.g = grads
        self.state = {part: [d[n] for n in names]
                      for part, d in state.items()}
        self.axes = [axes[n] for n in names]


# --------------------------------------------------------------------------
# the rules: init(p, axes) -> {part: tensor}; update(leaves, t, lr, wd) ->
# the updates to add to the params (t = the update's number, from 1)
# --------------------------------------------------------------------------
def _decayed(lv: Leaves, wd: float):
    """optax.add_decayed_weights ahead of the rule: g + wd * p."""
    if not wd:
        return lv.g
    return torch._foreach_add(lv.g, lv.p, alpha=wd)


def _moment(state, g, decay: float, order: int = 1):
    """optax update_moment in place: (1 - decay) * g**order + decay * m."""
    torch._foreach_mul_(state, decay)
    gg = torch._foreach_mul(g, g) if order == 2 else g
    torch._foreach_add_(state, gg, alpha=1.0 - decay)


class Sgd:
    """optax.sgd with momentum (trace), nesterov or not, after
    add_decayed_weights."""
    parts = ("trace",)

    def __init__(self, momentum: float, nesterov: bool):
        self.momentum, self.nesterov = momentum, nesterov

    def init(self, p, axes):
        return {"trace": torch.zeros_like(p)}

    def update(self, lv, t, lr, wd):
        g = _decayed(lv, wd)
        tr = lv.state["trace"]
        torch._foreach_mul_(tr, self.momentum)
        torch._foreach_add_(tr, g)
        u = torch._foreach_add(g, tr, alpha=self.momentum) \
            if self.nesterov else [x.clone() for x in tr]
        torch._foreach_mul_(u, -lr)
        return u


class Adam:
    """optax.scale_by_adam (nesterov: NAdam), then the learning rate; with
    ``decoupled`` optax.adamw's decay between the two, else the JAX
    chain's add_decayed_weights ahead of it."""
    parts = ("mu", "nu")

    def __init__(self, b1, b2, eps, nesterov=False, decoupled=False):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.nesterov, self.decoupled = nesterov, decoupled

    def init(self, p, axes):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def mu_hat(self, lv, g, t):
        mu = lv.state["mu"]
        if not self.nesterov:
            return torch._foreach_div(mu, _bias_correction(self.b1, t))
        m = torch._foreach_div(mu, _bias_correction(self.b1, t + 1))
        torch._foreach_mul_(m, self.b1)
        gh = torch._foreach_div(g, _bias_correction(self.b1, t))
        torch._foreach_add_(m, gh, alpha=1.0 - self.b1)
        return m

    def update(self, lv, t, lr, wd):
        g = lv.g if self.decoupled else _decayed(lv, wd)
        _moment(lv.state["mu"], g, self.b1)
        _moment(lv.state["nu"], g, self.b2, 2)
        den = torch._foreach_div(lv.state["nu"],
                                 _bias_correction(self.b2, t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = self.mu_hat(lv, g, t)
        torch._foreach_div_(u, den)
        if self.decoupled and wd:
            torch._foreach_add_(u, lv.p, alpha=wd)
        torch._foreach_mul_(u, -lr)
        return u


class AdaBelief(Adam):
    """optax.scale_by_belief: the second moment of g - mu, plus eps_root
    (kept in the state), after add_decayed_weights."""
    eps_root = 1e-16

    def update(self, lv, t, lr, wd):
        g = _decayed(lv, wd)
        mu, nu = lv.state["mu"], lv.state["nu"]
        _moment(mu, g, self.b1)
        _moment(nu, torch._foreach_sub(g, mu), self.b2, 2)
        torch._foreach_add_(nu, self.eps_root)
        den = torch._foreach_div(nu, _bias_correction(self.b2, t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu, _bias_correction(self.b1, t))
        torch._foreach_div_(u, den)
        torch._foreach_mul_(u, -lr)
        return u


class RAdam(Adam):
    """optax.scale_by_radam, threshold 5: the rectified Adam step once the
    SMA length ro reaches it, the bias-corrected momentum before (ro is a
    host value of t, computed in fp32 as optax does)."""

    def update(self, lv, t, lr, wd):
        g = _decayed(lv, wd)
        _moment(lv.state["mu"], g, self.b1)
        _moment(lv.state["nu"], g, self.b2, 2)
        f32 = np.float32
        ro_inf = f32(2.0 / (1.0 - self.b2) - 1.0)
        b2t = f32(self.b2) ** f32(t)
        ro = ro_inf - f32(2) * f32(t) * b2t / (f32(1) - b2t)
        u = torch._foreach_div(lv.state["mu"], _bias_correction(self.b1, t))
        if ro >= 5.0:
            r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * ro_inf
                        / ((ro_inf - f32(4)) * (ro_inf - f32(2)) * ro))
            den = torch._foreach_div(lv.state["nu"],
                                     _bias_correction(self.b2, t))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            torch._foreach_mul_(u, float(f32(r)))
            torch._foreach_div_(u, den)
        torch._foreach_mul_(u, -lr)
        return u


class AdaDelta:
    """optax.scale_by_adadelta (rho 0.9, eps 1e-6), then the learning rate;
    JAX's chain passes no weight decay."""
    parts = ("e_g", "e_x")
    rho, eps = 0.9, 1e-6

    def init(self, p, axes):
        return {"e_g": torch.zeros_like(p), "e_x": torch.zeros_like(p)}

    def update(self, lv, t, lr, wd):
        e_g, e_x = lv.state["e_g"], lv.state["e_x"]
        _moment(e_g, lv.g, self.rho, 2)
        num = torch._foreach_add(e_x, self.eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, self.eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        step = torch._foreach_mul(num, lv.g)
        _moment(e_x, step, self.rho, 2)
        torch._foreach_mul_(step, -lr)
        return step


class RmsProp:
    """optax.rmsprop (decay 0.9, eps inside the square root, not centred):
    g / sqrt(nu + eps), times the learning rate, then the momentum trace
    of those scaled steps. JAX's chain passes no weight decay."""
    parts = ("nu", "trace")
    decay = 0.9

    def __init__(self, eps: float, momentum: float):
        self.eps, self.momentum = eps, momentum

    def init(self, p, axes):
        return {"nu": torch.zeros_like(p), "trace": torch.zeros_like(p)}

    def update(self, lv, t, lr, wd):
        nu, tr = lv.state["nu"], lv.state["trace"]
        _moment(nu, lv.g, self.decay, 2)
        s = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(s)
        torch._foreach_mul_(s, lv.g)
        torch._foreach_mul_(s, -lr)
        torch._foreach_mul_(tr, self.momentum)
        torch._foreach_add_(tr, s)
        return [x.clone() for x in tr]


class NovoGrad:
    """optax.scale_by_novograd: a layer's second moment is the scalar
    |g|^2 (its first value, then a moment), the first moment
    b1 * mu + g / (sqrt(nu) + eps) + wd * p."""
    parts = ("mu", "nu")

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, p, axes):
        return {"mu": torch.zeros_like(p),
                "nu": torch.zeros((), dtype=p.dtype, device=p.device)}

    def update(self, lv, t, lr, wd):
        mu, nu = lv.state["mu"], lv.state["nu"]
        sq = complete_sums([n * n for n in torch._foreach_norm(lv.g)],
                           lv.shards)
        if t == 1:
            for n, s in zip(nu, sq):
                n.copy_(s)
        else:
            _moment(nu, sq, self.b2)
        den = torch._foreach_sqrt(nu)
        torch._foreach_add_(den, self.eps)
        add = [g / d for g, d in zip(lv.g, den)]
        if wd:
            torch._foreach_add_(add, lv.p, alpha=wd)
        if t == 1:
            for m, a in zip(mu, add):
                m.copy_(a)
        else:
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, add)
        return torch._foreach_mul(mu, -lr)


def _factored_dims(shape, axes, min_dim: int = 128):
    """optax ``_factored_dims`` on the Flax shape: (d1, d0), the second
    largest and the largest Flax axes when the second is at least
    min_dim, as torch axes; None for a leaf that is not factored."""
    if len(shape) < 2:
        return None
    flax_shape = [shape[a] for a in axes]
    order = np.argsort(flax_shape)
    if flax_shape[order[-2]] < min_dim:
        return None
    return axes[int(order[-2])], axes[int(order[-1])]


class Adafactor:
    """optax.adafactor's defaults: the factored second moment (decay
    1 - (t)^-0.8, eps 1e-30, factored over the two largest Flax axes of
    at least 128, else a full one), the update clipped to block RMS 1,
    times the learning rate, times the param's RMS (at least 1e-3),
    negated. JAX's chain passes no weight decay. Under FSDP the factoring
    follows the full shape; a factored moment keeps the shard's block
    along the split dim unless it averages over that dim, and then it is
    whole on every rank (``state_dims``)."""
    parts = ("v_row", "v_col", "v")
    decay_rate, eps = 0.8, 1e-30

    def init(self, p, axes, full=None):
        one = torch.zeros(1, dtype=p.dtype, device=p.device)
        dims = _factored_dims(full or p.shape, axes)
        if dims is None:
            return {"v_row": one, "v_col": one.clone(),
                    "v": torch.zeros_like(p)}
        d1, d0 = dims
        return {"v_row": torch.zeros_like(p.select(d0, 0)),
                "v_col": torch.zeros_like(p.select(d1, 0)),
                "v": one}

    def update(self, lv, t, lr, wd):
        rho = _f32(1.0 - np.float32(t) ** np.float32(-self.decay_rate))
        out = []
        for i, (p, g) in enumerate(zip(lv.p, lv.g)):
            sh = lv.shards[i]
            split = None if sh is None else sh.dim

            def mean(x, d, keepdim=False, split_at=split):
                # the mean over torch dim d of the full tensor
                if d != split_at:
                    return x.mean(d, keepdim=keepdim)
                return sh.sum_(x.sum(d, keepdim=keepdim)) / sh.full[split]

            def mean_all(x):
                if sh is None:
                    return x.mean()
                return sh.sum_(x.sum()) / sh.numel

            sq = g * g + self.eps
            dims = _factored_dims(p.shape if sh is None else sh.full,
                                  lv.axes[i])
            if dims is not None:
                d1, d0 = dims
                vr, vc = lv.state["v_row"][i], lv.state["v_col"][i]
                vr.mul_(rho).add_(mean(sq, d0), alpha=1.0 - rho)
                vc.mul_(rho).add_(mean(sq, d1), alpha=1.0 - rho)
                r1 = d1 - 1 if d1 > d0 else d1
                row = (vr / mean(vr, r1, True, r1 if split == d1 else None)
                       ) ** -0.5
                u = g * row.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
            else:
                v = lv.state["v"][i]
                v.mul_(rho).add_(sq, alpha=1.0 - rho)
                u = g * v ** -0.5
            u = u / torch.clamp(torch.sqrt(mean_all(u * u)), min=1.0)
            u = u * lr
            rms = torch.sqrt(mean_all(p * p))
            small = rms <= 1e-3
            scale = torch.where(small, torch.full_like(rms, 1e-3), rms)
            out.append(-(u * scale))
        return out

    def state_dims(self, full, axes, split: int) -> dict:
        """The split dim of each state part of a leaf split along
        ``split`` (None: whole on every rank)."""
        dims = _factored_dims(full, axes)
        if dims is None:
            return {"v_row": None, "v_col": None, "v": split}
        d1, d0 = dims

        def after_select(d):
            return None if split == d else split - (split > d)

        return {"v_row": after_select(d0), "v_col": after_select(d1),
                "v": None}


def _rows(x, axis: int):
    """x as [channels, rest] with the channel axis first."""
    return x.movedim(axis, 0).reshape(x.shape[axis], -1)


def _project(view_p, view_u):
    pn = view_p / (torch.linalg.vector_norm(view_p, dim=1, keepdim=True)
                   + 1e-8)
    return view_u - pn * (pn * view_u).sum(1, keepdim=True)


def project_perturb(p, g, perturb, axes, delta: float = 0.1,
                    wd_ratio: float = 0.01, shard=None):
    """AdamP's tangent-space projection (JAX ``_project_perturb``): where
    the gradient is near orthogonal to the weight, by channel (Flax's last
    axis) or by the whole tensor, the update's radial part is removed and
    the weight decay scaled by wd_ratio. Returns (perturb, decay factor),
    the branch taken on the device. ``shard``: the LeafShard when p, g
    and perturb are blocks of a split leaf (``_project_perturb_split``)."""
    if p.dim() <= 1:
        return perturb, 1.0
    if shard is not None:
        return _project_perturb_split(p, g, perturb, axes, delta, wd_ratio,
                                      shard)
    ch = axes[-1]
    pv, gv, uv = _rows(p, ch), _rows(g, ch), _rows(perturb, ch)
    cos_ch = ((pv * gv).sum(1) / (
        torch.linalg.vector_norm(pv, dim=1)
        * torch.linalg.vector_norm(gv, dim=1) + 1e-8)).abs().max()
    ch_proj = _project(pv, uv).reshape(
        (p.shape[ch],) + tuple(s for i, s in enumerate(p.shape) if i != ch)
    ).movedim(0, ch)
    ch_hit = cos_ch < delta / np.sqrt(np.float32(pv.shape[1]))
    pl, gl = p.reshape(1, -1), g.reshape(1, -1)
    cos_ly = (pl * gl).sum().abs() / (
        torch.linalg.vector_norm(pl) * torch.linalg.vector_norm(gl) + 1e-8)
    ly_proj = _project(pl, perturb.reshape(1, -1)).reshape(p.shape)
    ly_hit = cos_ly < delta / np.sqrt(np.float32(p.numel()))
    out = torch.where(ch_hit, ch_proj, torch.where(ly_hit, ly_proj, perturb))
    wd = torch.where(ch_hit | ly_hit, wd_ratio, 1.0).to(p.dtype)
    return out, wd


def _project_perturb_split(p, g, perturb, axes, delta, wd_ratio, shard):
    """``project_perturb`` on this rank's blocks of a split leaf: the
    channel rows' sums are completed over the ranks when the split dim is
    not the channel's (else the rows are whole here and only the largest
    cosine is), the layer's sums always; two all-reduces of the sums and,
    split along the channels, one of the largest cosine."""
    ch = axes[-1]
    pv, gv, uv = _rows(p, ch), _rows(g, ch), _rows(perturb, ch)
    rows_split = shard.dim != ch
    first = torch.cat([
        torch.stack([(pv * gv).sum(1), (pv * pv).sum(1), (gv * gv).sum(1)])
        .reshape(-1) if rows_split else pv.new_zeros(0),
        torch.stack([(p * g).sum(), (p * p).sum(), (g * g).sum()])])
    shard.sum_(first)
    if rows_split:
        dot_c, pp_c, gg_c = first[:-3].view(3, -1)
    else:
        dot_c, pp_c, gg_c = (pv * gv).sum(1), (pv * pv).sum(1), \
            (gv * gv).sum(1)
    dot_l, pp_l, gg_l = first[-3:]
    cos_ch = (dot_c / (torch.sqrt(pp_c) * torch.sqrt(gg_c) + 1e-8)).abs() \
        .max()
    if not rows_split:
        cos_ch = shard.max_(cos_ch)
    pn_c = pv / (torch.sqrt(pp_c)[:, None] + 1e-8)
    pl = p.reshape(-1)
    pn_l = pl / (torch.sqrt(pp_l) + 1e-8)
    second = torch.cat([(pn_c * uv).sum(1), (pn_l * perturb.reshape(-1))
                        .sum()[None]])
    if rows_split:
        shard.sum_(second)
    else:
        second[-1:] = shard.sum_(second[-1:].clone())
    ch_proj = (uv - pn_c * second[:-1, None]).reshape(
        (p.shape[ch],) + tuple(s for i, s in enumerate(p.shape) if i != ch)
    ).movedim(0, ch)
    rest = shard.numel // shard.full[ch]
    ch_hit = cos_ch < delta / np.sqrt(np.float32(rest))
    cos_ly = dot_l.abs() / (torch.sqrt(pp_l) * torch.sqrt(gg_l) + 1e-8)
    ly_proj = (perturb.reshape(-1) - pn_l * second[-1]).reshape(p.shape)
    ly_hit = cos_ly < delta / np.sqrt(np.float32(shard.numel))
    out = torch.where(ch_hit, ch_proj, torch.where(ly_hit, ly_proj, perturb))
    wd = torch.where(ch_hit | ly_hit, wd_ratio, 1.0).to(p.dtype)
    return out, wd


class AdamP:
    """The JAX package's AdamP (timm's, wd_ratio 0.01, nesterov)."""
    parts = ("mu", "nu")

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, p, axes):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def update(self, lv, t, lr, wd):
        b1, b2 = self.b1, self.b2
        mu, nu = lv.state["mu"], lv.state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, lv.g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(lv.g, lv.g), alpha=1 - b2)
        bc1, bc2 = _bias_correction(b1, t), _bias_correction(b2, t)
        out = []
        for i, p in enumerate(lv.p):
            g = lv.g[i]
            den = torch.sqrt(nu[i] / bc2) + self.eps
            perturb = (b1 * mu[i] + (1 - b1) * g) / den
            perturb, wdr = project_perturb(p, g, perturb, lv.axes[i],
                                           shard=lv.shards[i])
            upd = -(lr / bc1) * perturb
            if wd:
                upd = upd - lr * wd * wdr * p
            out.append(upd)
        return out


class SgdP:
    """The JAX package's SGDP (timm's, wd_ratio 0.01, nesterov)."""
    parts = ("buf",)

    def __init__(self, momentum: float):
        self.momentum = momentum

    def init(self, p, axes):
        return {"buf": torch.zeros_like(p)}

    def update(self, lv, t, lr, wd):
        m = self.momentum
        buf = lv.state["buf"]
        torch._foreach_mul_(buf, m)
        torch._foreach_add_(buf, lv.g)
        out = []
        for i, p in enumerate(lv.p):
            g = lv.g[i]
            d_p, wdr = project_perturb(p, g, g + m * buf[i], lv.axes[i],
                                       shard=lv.shards[i])
            upd = -lr * d_p
            if wd:
                upd = upd - lr * wd * wdr * p / (1.0 - m)
            out.append(upd)
        return out


class AdaHessian:
    """The JAX package's AdaHessian (timm's, hessian power 1): Adam whose
    second moment tracks the squared Hutchinson diagonal given at update
    time, decoupled decay p *= 1 - lr * wd."""
    parts = ("mu", "nu")
    needs_diag = True

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, p, axes):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def update(self, lv, t, lr, wd, diag):
        b1, b2 = self.b1, self.b2
        mu, nu = lv.state["mu"], lv.state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, lv.g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(diag, diag), alpha=1 - b2)
        bc1, bc2 = _bias_correction(b1, t), _bias_correction(b2, t)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_pow_(den, 0.5)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu, den)
        torch._foreach_mul_(u, -(lr / bc1))
        if wd:
            torch._foreach_add_(u, lv.p, alpha=-lr * wd)
        return u


LOOKAHEAD_SYNC, LOOKAHEAD_SLOW_STEP = 5, 0.5


def make_rule(name: str, cfg: OptimConfig):
    """The rule of an optimizer name (lower case, without lookahead_)."""
    b1, b2 = cfg.opt_betas or (0.9, 0.999)
    eps = cfg.opt_eps
    rules = {
        "sgd": lambda: Sgd(cfg.momentum, True),
        "nesterov": lambda: Sgd(cfg.momentum, True),
        "momentum": lambda: Sgd(cfg.momentum, False),
        "adam": lambda: Adam(b1, b2, eps),
        "adamw": lambda: Adam(b1, b2, eps, decoupled=True),
        "adabelief": lambda: AdaBelief(b1, b2, eps),
        "nadam": lambda: Adam(b1, b2, eps, nesterov=True),
        "radam": lambda: RAdam(b1, b2, eps),
        "adadelta": AdaDelta,
        "adafactor": Adafactor,
        "rmsprop": lambda: RmsProp(eps, cfg.momentum),
        "rmsproptf": lambda: RmsProp(eps, cfg.momentum),
        # optax.novograd is NVIDIA's layer-wise variant and serves both
        # of the reference's names (JAX optim.py:305-311)
        "novograd": lambda: NovoGrad(b1, b2, eps),
        "nvnovograd": lambda: NovoGrad(b1, b2, eps),
        "adamp": lambda: AdamP(b1, b2, eps),
        "sgdp": lambda: SgdP(cfg.momentum),
        "adahessian": lambda: AdaHessian(b1, b2, eps),
    }
    if name not in rules:
        raise ValueError(f"unsupported optimizer {cfg.opt!r}")
    return rules[name]()


@dataclasses.dataclass
class GroupedOptimizer:
    """clip_by_global_norm, then ``rule`` per group with its own learning
    rate and weight decay; "frozen" params get no update. ``lookahead``:
    each update is the fast one, and every LOOKAHEAD_SYNC-th the fast and
    slow weights meet halfway. ``lr_scale`` multiplies every learning
    rate (the host's plateau decay)."""

    rule: object
    labels: dict
    lr_fns: dict  # group -> step -> lr
    weight_decay: dict  # group -> decay
    clip_grad: Optional[float]
    axes: dict  # name -> Flax axes (flax_axes)
    lookahead: bool = False
    lr_scale: float = 1.0

    @property
    def needs_diag(self) -> bool:
        return getattr(self.rule, "needs_diag", False)

    def init(self, params: Mapping[str, torch.Tensor],
             shards: Optional[dict] = None) -> dict:
        """The state of ``params``; under FSDP of this rank's blocks, with
        ``shards`` ({name: LeafShard}) giving the split leaves' full
        shapes."""
        live = [n for n in params if self.labels[n] != "frozen"]
        state = {part: {} for part in self.rule.parts}
        shards = shards or {}
        for n in live:
            kw = {}
            if isinstance(self.rule, Adafactor) and n in shards:
                kw["full"] = shards[n].full
            for part, t in self.rule.init(params[n].detach(),
                                          self.axes[n], **kw).items():
                state[part][n] = t
        if self.lookahead:
            state["slow"] = {n: params[n].detach().clone() for n in live}
        return state

    def state_dims(self, name: str, full, split: Optional[int]) -> dict:
        """{part: the dim along which the state of ``name``, a leaf of
        ``full`` shape split along ``split``, is split (None: whole)}."""
        if split is None:
            return dict.fromkeys(self.state_parts())
        if isinstance(self.rule, Adafactor):
            dims = self.rule.state_dims(full, self.axes[name], split)
        else:  # every other part has the param's shape or is a scalar
            dims = {part: split for part in self.rule.parts}
            if isinstance(self.rule, NovoGrad):
                dims["nu"] = None
        if self.lookahead:
            dims["slow"] = split
        return dims

    def state_parts(self):
        return self.rule.parts + (("slow",) if self.lookahead else ())

    @torch.no_grad()
    def update(self, params, grads, state, count: int,
               grad_norm: Optional[torch.Tensor] = None,
               hessian_diag: Optional[dict] = None,
               shards: Optional[dict] = None):
        """Apply update number ``count`` (0 for the first) in place on
        params and state. grad_norm: the global norm of grads, if the
        caller has it; hessian_diag: {name: z * (H z)} (AdaHessian only,
        not clipped); shards: {name: LeafShard} of the split leaves whose
        blocks params, grads and state hold (FSDP)."""
        if self.needs_diag and hessian_diag is None:
            raise ValueError(
                "adahessian needs the Hutchinson diagonal: call "
                "update(..., hessian_diag=diag) (the train step does this "
                "when StepConfig.hutchinson is set)")
        names = [n for n in params if self.labels[n] != "frozen"]
        g = [grads[n] for n in names]
        if self.clip_grad is not None:
            if grad_norm is None:
                grad_norm = global_norm(
                    grads.values(), [(shards or {}).get(n) for n in grads])
            factor = torch.where(grad_norm < self.clip_grad,
                                 torch.ones_like(grad_norm),
                                 self.clip_grad / grad_norm)
            g = torch._foreach_mul(g, factor)
        g = dict(zip(names, g))
        parts = {p: state[p] for p in self.rule.parts}
        sync = self.lookahead and count % LOOKAHEAD_SYNC == \
            LOOKAHEAD_SYNC - 1
        for group in GROUPS:
            idx = [n for n in names if self.labels[n] == group]
            if not idx:
                continue
            lv = Leaves(idx, params, [g[n] for n in idx], parts, self.axes,
                        shards)
            lr = self.lr_fns[group](count) * self.lr_scale
            wd = self.weight_decay[group]
            if self.needs_diag:
                u = self.rule.update(lv, count + 1, lr, wd,
                                     [hessian_diag[n] for n in idx])
            else:
                u = self.rule.update(lv, count + 1, lr, wd)
            if sync:  # optax _lookahead_update at sync_next
                slow = [state["slow"][n] for n in idx]
                diff = torch._foreach_add(lv.p, u)
                torch._foreach_sub_(diff, slow)
                torch._foreach_add_(slow, diff, alpha=LOOKAHEAD_SLOW_STEP)
                torch._foreach_add_(u, diff,
                                    alpha=-(1 - LOOKAHEAD_SLOW_STEP))
            torch._foreach_add_(lv.p, u)


def create_optimizer(params: Mapping[str, torch.Tensor], cfg: OptimConfig,
                     base_schedule: Callable[[int], float],
                     new_module_names: List[str], steps_per_epoch: int = 1):
    """(optimizer, labels). `base_schedule` maps optimizer step -> lr
    (see train/scheduler.py)."""
    name = cfg.opt.lower()
    lookahead = name.startswith("lookahead_")
    if lookahead:
        name = name.split("_", 1)[1]
        if name == "adahessian":
            raise ValueError(
                "lookahead_adahessian is unsupported; use plain adahessian")
    rule = make_rule(name, cfg)
    labels = param_labels(params, new_module_names, cfg)
    full = group_lr_fn(base_schedule, 1.0, 0, steps_per_epoch)
    backbone = group_lr_fn(base_schedule, cfg.backbone_lr_scale,
                           cfg.backbone_freeze_steps, steps_per_epoch)
    clip = cfg.clip_grad if cfg.clip_grad is not None and cfg.clip_grad > 0 \
        else None
    opt = GroupedOptimizer(
        rule=rule, labels=labels,
        lr_fns={"new_param": full, "new_param_no_decay": full,
                "decay": backbone, "no_decay": backbone},
        weight_decay={"new_param": cfg.weight_decay, "decay": cfg.weight_decay,
                      "new_param_no_decay": 0.0, "no_decay": 0.0},
        clip_grad=clip,
        axes={n: flax_axes(n, p.dim()) for n, p in params.items()},
        lookahead=lookahead)
    return opt, labels


@torch.no_grad()
def project_params(params: Mapping[str, torch.Tensor],
                   shards: Optional[dict] = None):
    """The projection the reference makes inside its forward
    (models/sinkhorn.py:73-76), after the update and in place (JAX
    train/optim.py:391-402): every Sinkhorn cluster vector
    ``cluster_layers.{k}.v`` renormalised onto the unit sphere. A block
    split along the vectors' last dim (FSDP) sums its squares over the
    ranks."""
    shards = shards or {}
    for name, p in params.items():
        if name.split(".")[-1] == "v" and "cluster_layers" in name:
            sh = shards.get(name)
            if sh is not None and sh.dim == p.dim() - 1:
                p.div_(torch.sqrt(sh.sum_((p * p).sum(-1, keepdim=True))))
            else:
                p.div_(torch.linalg.vector_norm(p, dim=-1, keepdim=True))


@torch.no_grad()
def ema_update(ema_params, params, decay: float):
    """ModelEmaV2 semantics (timm), in place: ema = decay*ema +
    (1-decay)*param."""
    ema = list(ema_params.values())
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [params[n] for n in ema_params], alpha=1.0 - decay)
