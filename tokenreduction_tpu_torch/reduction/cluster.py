"""The cluster family: SiT, PatchMerger, Sinkhorn, DPC-KNN and k-medoids.

Counterpart of ``tokenreduction_tpu/reduction/cluster.py``. The blocks
stay stock; between them, at each reduction block, the patch tokens (the
prefix tokens split off first) are clustered or merged into fewer tokens
(reference models/sit.py:115-128 and its siblings). The clustering is
plain PyTorch on every device, as it is XLA in the JAX package; the
blocks run the kernels: in eval every block of SiT, PatchMerger,
Sinkhorn and DPC-KNN is one ``fused_full_block``; k-medoids' block
before each reduction asks for ``score="colsum"`` (one
``fused_block_attention`` and one ``fused_mlp_residual`` in eval, the
attention core ``attention_core_train`` in training). The modules
between the blocks are ``cluster_layers.{k}``: the optimizer gives the
parameters under that name full LR (``new_module_names``, reference
optim.py:45-46).

Weights: every Linear truncated normal (std 0.02), PatchMerger's
``queries`` and Sinkhorn's ``v`` N(0, 1), SiT's ``scale`` ones, all from
the model's generator, as the Flax initialisers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tokenreduction_tpu_torch.core.config import reduction_schedule
from tokenreduction_tpu_torch.models.deit import ViTBase
from tokenreduction_tpu_torch.ops.dpc_knn import (
    cluster_dpc_knn,
    merge_clusters,
)
from tokenreduction_tpu_torch.ops.gather import take_tokens
from tokenreduction_tpu_torch.ops.kmedoids import k_medoids_fit
from tokenreduction_tpu_torch.ops.sinkhorn import log_optimal_transport
from tokenreduction_tpu_torch.parallel.mesh import draw_rows


def _weighted_sum(w, x):
    """w [B, K, N] x [B, N, C] -> [B, K, C]: w rounded to x's dtype, as
    the JAX modules cast it, then summed in fp32 and rounded to x's
    dtype."""
    return torch.bmm(w.to(x.dtype).float(), x.float()).to(x.dtype)


class TokenSlimmingModule(nn.Module):
    """SiT: token-wise MLP logits, a softmax over tokens with a learned
    temperature (reference models/sit.py:25-40)."""

    def __init__(self, embed_dim: int, cluster_centers: int,
                 ratio: float = 0.5):
        super().__init__()
        h = int(embed_dim * ratio)
        self.weight_ln = nn.LayerNorm(embed_dim, eps=1e-5)
        self.weight_fc1 = nn.Linear(embed_dim, h)
        self.weight_fc2 = nn.Linear(h, cluster_centers)
        self.scale = nn.Parameter(torch.ones(1, 1, 1))

    def forward(self, x):
        w = self.weight_fc2(F.gelu(self.weight_fc1(self.weight_ln(x))))
        w = torch.softmax(w * self.scale, dim=1).transpose(1, 2)  # [B, K, N]
        return _weighted_sum(w, x), w, None


class PatchMerger(nn.Module):
    """Learned queries attending over the LayerNormed tokens, unscaled
    (reference models/patchmerger.py:24-39)."""

    def __init__(self, embed_dim: int, cluster_centers: int):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.queries = nn.Parameter(torch.zeros(cluster_centers, embed_dim))

    def forward(self, x):
        x = self.norm(x)
        sim = torch.einsum("kd,bnd->bkn", self.queries.float(), x.float())
        attn = torch.softmax(sim, dim=-1)
        return _weighted_sum(attn, x), attn, self.queries


class SinkhornCluster(nn.Module):
    """Learned cluster vectors on the unit sphere and a log-space optimal
    transport assignment (reference models/sinkhorn.py:59-86). The
    reference renormalises ``v`` in place in every forward; here the
    forward uses normalize(v) with an identity gradient (straight
    through), and the train step projects ``v`` back onto the sphere
    after each update (``StepConfig.project_sinkhorn``)."""

    def __init__(self, embed_dim: int, cluster_centers: int, eps: float,
                 iters: int):
        super().__init__()
        self.eps, self.iters = eps, iters
        self.v = nn.Parameter(torch.zeros(cluster_centers, embed_dim))

    def forward(self, x):
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        v = self.v
        v_used = v + (v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
                      - v).detach()
        scores = torch.einsum("bnd,kd->bkn", x.float(), v_used.float())
        weights = log_optimal_transport(scores, self.eps, self.iters)
        return _weighted_sum(weights, x), weights, v_used


class CTM(nn.Module):
    """DPC-KNN clustering and a merge weighted by a learned score
    (reference models/dpcknn.py:143-172)."""

    def __init__(self, embed_dim: int, cluster_num: int, k: int = 5,
                 equal_weight: bool = False):
        super().__init__()
        self.cluster_num, self.k = cluster_num, k
        self.score = None if equal_weight else nn.Linear(embed_dim, 1)

    def forward(self, x, idx_token, agg_weight, noise=None):
        token_weight = None if self.score is None else self.score(x).exp()
        idx_cluster, idx_centers = cluster_dpc_knn(x, self.cluster_num,
                                                   self.k, noise=noise)
        centers = take_tokens(x, idx_centers)
        x, idx_token, agg_weight = merge_clusters(
            x, idx_cluster, self.cluster_num, token_weight, idx_token,
            agg_weight)
        return x, idx_token, agg_weight, idx_centers, idx_cluster, centers


class _ClusterViT(ViTBase):
    """The family's common scaffold: the schedule, the cluster layers and
    their N(0, 1) initialisers (SiT's ``scale`` is made as ones)."""

    @staticmethod
    def new_module_names():
        return ["cluster_layers"]

    def make_cluster_layer(self, k: int) -> nn.Module | None:
        """The module between the blocks at reduction stage k (None for
        k-medoids, which has no parameters)."""
        return None

    def make_modules(self):
        self.schedule = reduction_schedule(self.cfg)
        layers = [self.make_cluster_layer(k)
                  for k in range(len(self.cfg.reduction_loc))]
        if any(m is not None for m in layers):
            self.cluster_layers = nn.ModuleList(layers)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        super().init_weights(generator)
        for m in self.modules():
            if isinstance(m, PatchMerger):
                m.queries.normal_(generator=generator)
            elif isinstance(m, SinkhornCluster):
                m.v.normal_(generator=generator)

    def finish(self, x, viz):
        """The final features in viz mode, then the classifier; returns
        what forward returns."""
        c = self.cfg
        if c.viz_mode and (c.depth - 1) not in viz["Features"]:
            viz["Features"][c.depth - 1] = x
        out = self.classify(x)
        if c.viz_mode and not self.training:
            return out, viz
        return out


class _SoftClusterViT(_ClusterViT):
    """SiT, PatchMerger and Sinkhorn share one loop; only the cluster
    layer, and whether it has centre features, differ."""

    capture_centers = False

    def forward(self, x, generator: torch.Generator | None = None):
        """Logits; in eval with ``cfg.viz_mode`` also
        {"Soft_Assignment_Maps": {block: [B, K, N]}, "Assignment_Maps":
        {block: [B, N] the argmax over the K centres}, "Features": {block:
        tokens after it}} and, for PatchMerger and Sinkhorn,
        "Center_Feats": {block: [B, K, D] the queries or the normalised
        vectors}."""
        c = self.cfg
        p = c.num_prefix_tokens
        x = self.embed(x, generator)
        viz = {"Assignment_Maps": {}, "Soft_Assignment_Maps": {},
               "Features": {}}
        if self.capture_centers:
            viz["Center_Feats"] = {}
        stage = 0  # the stages in block order, as JAX's cnt
        for i, blk in enumerate(self.blocks):
            if i in c.reduction_loc:
                rest, soft, centers = self.cluster_layers[stage](x[:, p:])
                stage += 1
                if c.viz_mode:
                    viz["Soft_Assignment_Maps"][i] = soft
                    viz["Assignment_Maps"][i] = soft.argmax(-2)
                    if self.capture_centers:
                        viz["Center_Feats"][i] = centers.detach()[None] \
                            .expand(x.shape[0], -1, -1)
                x = torch.cat([x[:, :p], rest], dim=1)
            x, _ = blk(x, generator=generator)
            if c.viz_mode and i in c.reduction_loc:
                viz["Features"][i] = x
        return self.finish(x, viz)


class SiTVisionTransformer(_SoftClusterViT):
    def make_cluster_layer(self, k):
        return TokenSlimmingModule(self.cfg.embed_dim, self.schedule[k])


class PatchMergerVisionTransformer(_SoftClusterViT):
    capture_centers = True

    def make_cluster_layer(self, k):
        return PatchMerger(self.cfg.embed_dim, self.schedule[k])


class SinkhornVisionTransformer(_SoftClusterViT):
    capture_centers = True

    def make_cluster_layer(self, k):
        c = self.cfg
        return SinkhornCluster(c.embed_dim, self.schedule[k], c.sinkhorn_eps,
                               c.cluster_iters)


class DPCKNNVisionTransformer(_ClusterViT):
    def make_cluster_layer(self, k):
        c = self.cfg
        return CTM(c.embed_dim, self.schedule[k], c.k_neighbors,
                   c.equal_weight)

    def forward(self, x, generator: torch.Generator | None = None):
        """Logits; in eval with ``cfg.viz_mode`` also {"Kept_Tokens":
        {block: [B, K] centre ids}, "Assignment_Maps": {block: [B, N]
        cluster ids}, "Center_Feats": {block: [B, K, D] the centres before
        the merge}, "Features": {block: tokens after it}}. ``generator``,
        where given, draws the density noise (eval and training) and the
        stochastic-depth masks; without it the clustering takes no
        noise."""
        c = self.cfg
        p = c.num_prefix_tokens
        x = self.embed(x, generator)
        B = x.shape[0]
        idx_token = torch.arange(c.num_patches, device=x.device) \
            .expand(B, -1)
        agg_weight = torch.ones(B, c.num_patches, 1, dtype=x.dtype,
                                device=x.device)
        viz = {"Kept_Tokens": {}, "Assignment_Maps": {}, "Center_Feats": {},
               "Features": {}}
        stage = 0  # the stages in block order, as JAX's cnt
        for i, blk in enumerate(self.blocks):
            if i in c.reduction_loc:
                rest = x[:, p:]
                noise = None
                if generator is not None:
                    noise = draw_rows(torch.rand, rest.shape[:2],
                                      generator=generator,
                                      device=x.device).to(rest.dtype)
                rest, idx_token, agg_weight, idx_centers, idx_cluster, \
                    centers = self.cluster_layers[stage](
                        rest, idx_token, agg_weight, noise)
                stage += 1
                if c.viz_mode:
                    viz["Kept_Tokens"][i] = idx_centers
                    viz["Assignment_Maps"][i] = idx_cluster
                    viz["Center_Feats"][i] = centers
                x = torch.cat([x[:, :p], rest], dim=1)
            x, _ = blk(x, generator=generator)
            if c.viz_mode and i in c.reduction_loc:
                viz["Features"][i] = x
        return self.finish(x, viz)


class KMedoidsVisionTransformer(_ClusterViT):
    def __init__(self, cfg, **kwargs):
        if not all(loc > 0 for loc in cfg.reduction_loc):
            raise ValueError(
                "k-medoids needs attention weights from the preceding block "
                "(reduction at block 0 is undefined; the reference crashes "
                "there, models/kmedoids.py:237-251)")
        super().__init__(cfg, **kwargs)

    def forward(self, x, generator: torch.Generator | None = None):
        """Logits; in eval with ``cfg.viz_mode`` also {"Kept_Tokens":
        {block: [B, K] medoid ids}, "Assignment_Maps": {block: [B, N]
        cluster ids}, "Center_Feats": {block: [B, K, D] the medoids},
        "Features": {block: tokens after it}}. The token weights are the
        attention mass of the block before (``score="colsum"``); with
        ``cfg.equal_weight`` they are equal and ``generator`` draws the
        first medoid of the farthest-point init (one draw for the
        batch)."""
        c = self.cfg
        p = c.num_prefix_tokens
        x = self.embed(x, generator)
        viz = {"Kept_Tokens": {}, "Assignment_Maps": {}, "Center_Feats": {},
               "Features": {}}
        colsum = None
        stage = 0  # the stages in block order, as JAX's cnt
        for i, blk in enumerate(self.blocks):
            if i in c.reduction_loc:
                weights = first = None
                if not c.equal_weight:
                    weights = colsum[:, p:, None]
                elif generator is not None:
                    first = torch.randint(x.shape[1] - p, (),
                                          generator=generator,
                                          device=generator.device)
                centers, idx_centers, assignment = k_medoids_fit(
                    x[:, p:], self.schedule[stage], c.cluster_iters, weights,
                    first=first)
                if c.viz_mode:
                    viz["Kept_Tokens"][i] = idx_centers
                    viz["Assignment_Maps"][i] = assignment
                    viz["Center_Feats"][i] = centers
                x = torch.cat([x[:, :p], centers], dim=1)
                stage += 1
            # the attention mass is needed only before a reduction
            want = "colsum" if (i + 1) in c.reduction_loc else None
            x, (aux, _) = blk(x, score=want, generator=generator)
            if aux is not None:
                colsum = aux
            if c.viz_mode and i in c.reduction_loc:
                viz["Features"][i] = x
        return self.finish(x, viz)
