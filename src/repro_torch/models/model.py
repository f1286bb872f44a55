"""Model facade: parameters, the training loss, prefill, decode and the
full forward.

The counterpart of the reference's ``repro/models/model.py`` as an
``nn.Module`` that owns its parameters (the reference keeps them in a
separate tree).  Parameters are fp32, laid out as the reference's
(``wq`` (D, H, Dh), ...), with the layers unstacked into ``blocks`` in
layer order; the state dict's names are ``embed.tok``,
``final_norm.<scale|bias>``, ``unembed.w`` (untied only),
``blocks.<i>.<part>.<name>`` (``ln1``, ``attn``, ``mlp``, ``moe``,
``xattn``, ``gate``, ``rec``, ``mix``, ...), ``img_proj.w`` (VLM) and
``encoder.{blocks.<i>.<part>.<name>, final_norm.<name>, in_proj.w}``
(encoder-decoder); ``convert.lm_params_from_reference`` builds one
from the reference's tree.  A batch holds ``tokens`` and, for the VLM,
``image_embeds`` (B, n_image_tokens, D) or, for the audio model,
``audio_embeds`` (B, encoder_seq, D).  ``loss`` is the reference's
chunked cross-entropy plus the MoE router's auxiliary loss,
differentiable (``train/train_step.py`` takes its gradients); the
serving methods run without autograd.  The shape-only methods of the
reference's dry-run (``param_shapes``, ``logical_axes``, ``cache_shapes``)
read the parameters' specs and shapes, keyed by state-dict name
(``convert`` maps these names to the reference's tree paths): on a model
built with ``device="meta"`` nothing is allocated.  Over a mesh
(``train/train_step.py``) the parameters are DTensors, placed by the
logical-axis rules; the model's code runs on them unchanged under
:meth:`Model.spmd`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.frontier import resolve_device
from ..kernels.flash_attention.ops import IMPLS
from . import specs as S
from . import transformer as T
from .kvcache import Caches, block_cache_shapes, init_cache


class Model(nn.Module):
    """A decoder LM of any of the reference's families on ``device`` (``"cuda"`` by default: without
    CUDA the constructor raises unless ``device="cpu"`` is given).
    ``impl`` picks the attention path of prefill, the full forward and
    the loss (``ops.IMPLS``; the reference's default is ``"xla"``, the
    port's ``"fused"``, the CUDA kernel, whose gradients come from the
    plain path).  A config that sets a field the port does not honour raises
    ``NotImplementedError`` (``ArchConfig.check_ported``).  The
    constructor initialises the parameters from a ``torch.Generator``
    seeded 0 on the model's device; on ``device="meta"`` it builds
    shapes only, uninitialised, for the dry-run."""

    def __init__(self, cfg: ArchConfig, *, impl: str = "fused",
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        cfg.check_ported()
        if impl not in IMPLS:
            raise ValueError(f"attention impl {impl!r}: one of {IMPLS}")
        self.cfg = cfg
        self.impl = impl
        meta = torch.device(device).type == "meta"
        self.device = torch.device("meta") if meta else resolve_device(device)
        top = S.model_specs(cfg)
        self.embed = S.param_tree(top["embed"], self.device)
        self.final_norm = S.param_tree(top["final_norm"], self.device)
        if not cfg.tie_embeddings:
            self.unembed = S.param_tree(top["unembed"], self.device)
        self.blocks = nn.ModuleList(
            S.param_tree(S.block_specs(cfg, kind), self.device)
            for kind in cfg.layer_kinds())
        if "img_proj" in top:
            self.img_proj = S.param_tree(top["img_proj"], self.device)
        if "encoder" in top:
            enc = top["encoder"]
            self.encoder = nn.ModuleDict({
                "blocks": nn.ModuleList(
                    S.param_tree(S.block_specs(cfg, "enc"), self.device)
                    for _ in range(cfg.n_encoder_layers)),
                "final_norm": S.param_tree(enc["final_norm"], self.device),
                "in_proj": S.param_tree(enc["in_proj"], self.device)})
        if not meta:
            self.reset_parameters(
                torch.Generator(device=self.device).manual_seed(0))

    # -- parameters ---------------------------------------------------------
    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def param_shapes(self) -> Dict[str, S.TensorSpec]:
        """Every parameter's (global) shape and dtype (fp32), by name."""
        return {name: S.TensorSpec(tuple(p.shape), torch.float32)
                for name, p in self.named_parameters()}

    def logical_axes(self) -> Dict[str, S.Logical]:
        """Every parameter's logical axes (its spec's), by name."""
        return {name: p.spec.logical for name, p in self.named_parameters()}

    def cache_shapes(self, batch: int, seq: int
                     ) -> List[Dict[str, S.TensorSpec]]:
        """The serving caches' shapes and dtypes, one dict a layer (as
        :meth:`init_cache` would allocate them)."""
        return [{name: S.TensorSpec(*sd) for name, sd in
                 block_cache_shapes(self.cfg, kind, batch, seq).items()}
                for kind in self.cfg.layer_kinds()]

    def spmd(self):
        """The context the model's code runs in over a mesh: plain tensors
        made inside it (masks, positions, scalars) count as replicated
        (``implicit_replication``).  A no-op for a model whose parameters
        are plain tensors."""
        if not hasattr(self.embed._parameters["tok"], "device_mesh"):
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fill every parameter from its spec (normal(0, scale), ones,
        zeros, or uniform on [-8, -4) for RG-LRU and RWKV decays) with
        ``generator``, which must live on the model's device,
        in the state dict's order."""
        for p in self.parameters():
            S.init_(p, generator)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    def _inputs(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch's tokens and modality embeds on the model's device."""
        out = {"tokens": self._tokens(batch["tokens"])}
        for key in ("image_embeds", "audio_embeds"):
            if key in batch:
                out[key] = torch.as_tensor(batch[key], device=self.device)
        return out

    # -- training -----------------------------------------------------------
    loss_chunk: int = 512

    def loss(self, batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Masked mean cross-entropy of ``batch["targets"]`` (B, T) given
        ``batch["tokens"]`` (B, T), plus the auxiliary loss: (loss,
        metrics ``loss``, ``ce``, ``aux``, ``tokens``, detached).  The
        reference's chunked loss: chunks of ``loss_chunk`` positions (T
        when that does not divide T), each chunk's (B, c, V) fp32 logits
        under ``torch.utils.checkpoint`` when grad is enabled, so backward
        recomputes them and the (B, T, V) logits never exist at once.
        ``batch["mask"]`` (B, T) weights the targets, ones by default;
        the mean divides by max(mask sum, 1).  A ``cost_exact`` config
        takes one chunk (the reference's cost-probe mode)."""
        targets = self._tokens(batch["targets"])
        hidden, aux = T.forward_hidden(self.cfg, self, self._inputs(batch),
                                       impl=self.impl)
        mask = batch.get("mask")
        mask = torch.ones(targets.shape, device=self.device) \
            if mask is None else torch.as_tensor(
                mask, dtype=torch.float32, device=self.device)
        t = hidden.shape[1]
        c = self.loss_chunk if t % self.loss_chunk == 0 else t
        if self.cfg.cost_exact:
            c = t                  # cost-probe mode: one chunk
        remat = torch.is_grad_enabled()
        nll_sum = torch.zeros((), device=self.device)
        mask_sum = torch.zeros((), device=self.device)
        for i in range(0, t, c):
            args = (hidden[:, i:i + c], targets[:, i:i + c], mask[:, i:i + c])
            nll = checkpoint(self._chunk_nll, *args, use_reentrant=False) \
                if remat else self._chunk_nll(*args)
            nll_sum = nll_sum + nll
            mask_sum = mask_sum + args[2].sum()
        ce = nll_sum / torch.clamp(mask_sum, min=1.0)
        loss = ce + aux
        return loss, {"loss": loss.detach(), "ce": ce.detach(),
                      "aux": aux.detach(), "tokens": mask_sum.detach()}

    def _chunk_nll(self, h, targets, mask) -> torch.Tensor:
        """Summed masked negative log-likelihood of one chunk: the fp32
        log-softmax's entry at each target (``F.cross_entropy``; over a
        mesh, :func:`_rows_cross_entropy`)."""
        logits = T.logits_fn(self.cfg, self, h).flatten(0, 1)
        targets = targets.flatten()
        if hasattr(logits, "device_mesh"):
            nll = _rows_cross_entropy(logits, targets)
        else:
            nll = F.cross_entropy(logits, targets, reduction="none")
        return (nll * mask.flatten()).sum()

    # -- serving --------------------------------------------------------------

    @torch.no_grad()
    def forward(self, batch: Dict) -> torch.Tensor:
        """Logits (B, T, V) in fp32 over the whole sequence
        (``transformer.forward`` also gives the auxiliary loss)."""
        return T.forward(self.cfg, self, self._inputs(batch),
                         impl=self.impl)[0]

    @torch.no_grad()
    def prefill(self, batch: Dict) -> Tuple[torch.Tensor, Caches]:
        """(last-position logits (B, V), caches) of ``batch["tokens"]``
        (with its image or audio embeds)."""
        return T.prefill(self.cfg, self, self._inputs(batch),
                         impl=self.impl)

    @torch.no_grad()
    def decode(self, caches: Caches, tokens, pos: int,
               ) -> Tuple[torch.Tensor, Caches]:
        """One token (B, 1) at absolute position ``pos``: (logits (B, V),
        caches).  The KV and ring caches are updated in place; the
        recurrent states are replaced in the returned caches.  The
        cross caches hold what decode needs of the image or audio."""
        return T.decode_step(self.cfg, self, caches, self._tokens(tokens),
                             pos, impl=self.impl)

    def init_cache(self, batch: int, seq: int) -> Caches:
        return init_cache(self.cfg, batch, seq, self.device)


def _rows_cross_entropy(logits, targets):
    """Per-row cross-entropy of DTensor logits (N, V), each rank on its own
    rows (the batch split).  A head split over the vocabulary computes
    it on its own columns (:class:`_VocabParallelNLL`: three all-reduces
    of one number a row over ``"model"``, the counterpart of
    ``loss_parallel``, which takes one-dimensional meshes only in
    PyTorch 2.11); a whole vocabulary takes ``F.cross_entropy``."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    rows = list(targets.placements)
    if Shard(1) not in logits.placements:
        fn, where = (lambda lg, t: F.cross_entropy(lg, t, reduction="none"),
                     rows)
    else:
        group = mesh.get_group("model")
        where = [Shard(1) if n == "model" else p
                 for n, p in zip(mesh.mesh_dim_names, rows)]

        def fn(lg, t):
            lo = mesh.get_local_rank("model") * lg.shape[1]
            return _VocabParallelNLL.apply(lg, t, lo, group)
    return local_map(fn, out_placements=rows, in_placements=(where, rows),
                     device_mesh=mesh, redistribute_inputs=True)(
                         logits, targets)


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[target] of each row, the vocabulary split over
    a process group: ``logits`` (N, V / ranks) fp32 are this rank's
    columns ``lo ..``, ``target`` (N,) global ids.  The row max, the
    sum of exponentials and the target's logit are all-reduced (max,
    sum, sum); backward is local (softmax minus the one-hot)."""

    @staticmethod
    def forward(ctx, logits, target, lo, group):
        import torch.distributed as dist
        m = logits.max(dim=-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[:, None])
        total = e.sum(-1)
        dist.all_reduce(total, group=group)
        inside = (target >= lo) & (target < lo + logits.shape[1])
        col = torch.where(inside, target - lo, 0)
        picked = (logits.gather(1, col[:, None])[:, 0] - m) * inside
        dist.all_reduce(picked, group=group)
        ctx.save_for_backward(e, total, col, inside)
        return torch.log(total) - picked

    @staticmethod
    def backward(ctx, grad):
        e, total, col, inside = ctx.saved_tensors
        g = e / total[:, None]
        g.scatter_add_(1, col[:, None], -inside[:, None].to(g.dtype))
        return g * grad[:, None], None, None, None
