"""Eval engine assembly: towers -> embeddings -> zero-shot + retrieval
(port of ``repro.eval.engine``).

``ClipEvaluator`` is the reusable evaluator (the CLI and the trainer's
periodic hook): it memoises rendered prompt banks per class set and the
classifier head per params key, and computes

    zs_top{k}        prompt-ensemble zero-shot classification accuracy
    i2t_r@{k} / t2i_r@{k}   exact global retrieval recall (streaming
                            chunked top-k, no (N, N) matrix)
    eval_loss        (optional) the GCL batch value at a reference tau,
                     honouring the training ``loss_impl`` knob ("fused"
                     is K1)

``evaluate_embeddings`` is the tower-independent core shared with the
planted known-answer path; with ``mesh`` + ``axes`` its retrieval scan
runs sharded over the mesh's ranks (rows by sample ownership, columns
gathered), bit-identical to the single-device scan.  ``ClipEvaluator``
with ``param_dims`` consumes a rank's param shards of the (data, fsdp)
mesh (the trainer's ``--eval-every``): it gathers them over ``fsdp`` on
the device once per pass.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch import device as D
from repro_torch.eval import classifier as CL
from repro_torch.eval import extraction as EX
from repro_torch.eval import metrics as M
from repro_torch.eval import planted as PL
from repro_torch.eval import retrieval as RT
from repro_torch.eval.templates import DEFAULT_TEMPLATES
from repro_torch.models import backbones as BB
from repro_torch.models import clip as C
from repro_torch.models import precision as PR


def evaluate_embeddings(e1n, e2n, labels=None, head=None, *,
                        ks: Sequence[int] = (1, 5, 10),
                        top_ks: Sequence[int] = (1, 5),
                        chunk: int = RT.CHUNK,
                        loss_impl: Optional[str] = None, tau: float = 0.07,
                        device=None, mesh=None, axes=None) -> dict:
    """Metrics from already-normalised (N, E) embeddings (numpy arrays or
    tensors), computed on ``device`` (default: the card).  With ``mesh``
    + ``axes`` every rank passes the same embeddings and the retrieval
    scan runs sharded over the ranks (a collective)."""
    dev = D.resolve(device)
    e1n = torch.as_tensor(e1n).to(dev)
    e2n = torch.as_tensor(e2n).to(dev)
    out = {}
    with torch.inference_mode():
        if head is not None:
            out.update(CL.zero_shot_metrics(e1n, head.to(dev), labels,
                                            top_ks))
        if mesh is not None:
            out.update(RT.sharded_retrieval_recalls(mesh, axes, e1n, e2n, ks,
                                                    chunk=chunk))
        else:
            out.update(RT.retrieval_recalls(e1n, e2n, ks, chunk=chunk))
        if loss_impl is not None:
            out["eval_loss"] = M.contrastive_eval_loss(e1n, e2n, tau,
                                                       loss_impl=loss_impl)
    return {k: float(v) for k, v in out.items()}


class ClipEvaluator:
    """Zero-shot + retrieval evaluator over a class-structured split for
    the clip family, through the tower fast path (``impl``/``precision``
    as in training; ``impl="flash"`` is the attention kernel)."""

    def __init__(self, cfg, dataset, *, impl: str = "flash",
                 precision=None, batch_size: int = 64, prefetch: int = 2,
                 ks: Sequence[int] = (1, 5, 10),
                 top_ks: Sequence[int] = (1, 5), chunk: int = RT.CHUNK,
                 templates=DEFAULT_TEMPLATES,
                 loss_impl: Optional[str] = None, tau: float = 0.07,
                 device=None, param_dims=None, mesh=None):
        if cfg.family != "clip":
            raise ValueError("ClipEvaluator needs a clip-family arch; got "
                             f"{cfg.family!r}")
        prec = PR.get_precision(precision or cfg.precision)
        self.cfg = cfg
        self.dataset = dataset
        self.device = D.resolve(device)
        self.ks, self.top_ks = tuple(ks), tuple(top_ks)
        self.chunk = chunk
        self.templates = templates
        self.loss_impl, self.tau = loss_impl, tau
        self.batch_size, self.prefetch = batch_size, prefetch
        self.head_cache: dict = {}
        self._head_key = None
        # the training layout of the (data, fsdp) mesh: evaluate() takes
        # a rank's param shards and gathers them on the device
        self.param_dims, self.mesh = param_dims, mesh
        self._encode_pair = (lambda p, b: BB.encode_pair(
            p, cfg, b, impl=impl, precision=prec))
        self._encode_text = (lambda p, t: C.encode_text(
            p, t, impl=impl, precision=prec))

    def evaluate(self, params, *, cache_key=None) -> dict:
        """Full eval pass.  ``cache_key``: identity of ``params`` (e.g.
        the train step): repeated evals at the same key reuse the
        classifier head for this class set.  With ``param_dims``,
        ``params`` are this rank's shards (a collective)."""
        if self.param_dims is not None:
            params = EX.sharded_params(self.cfg, params, self.param_dims,
                                       self.mesh, self.device)
        e1n, e2n = EX.extract_pair_embeddings(
            self._encode_pair, params, self.dataset,
            batch_size=self.batch_size, prefetch=self.prefetch,
            device=self.device)
        if cache_key != self._head_key:
            # heads depend on the params: a new key (a new train step)
            # can never hit old entries, so drop them
            self.head_cache.clear()
            self._head_key = cache_key
        head = CL.build_head(
            lambda t: self._encode_text(params, t),
            self.dataset.tok_base,
            context_length=self.dataset.context_length,
            templates=self.templates,
            cache=self.head_cache if cache_key is not None else None,
            cache_key=cache_key, device=self.device)
        labels = getattr(self.dataset, "labels", None)
        if labels is None:
            labels = self.dataset.classes
        return evaluate_embeddings(
            e1n, e2n, labels, head, ks=self.ks, top_ks=self.top_ks,
            chunk=self.chunk, loss_impl=self.loss_impl, tau=self.tau,
            device=self.device)


def evaluate_planted(params, dataset, *, ks: Sequence[int] = (1, 5, 10),
                     top_ks: Sequence[int] = (1, 5),
                     chunk: int = RT.CHUNK, batch_size: int = 64,
                     templates=DEFAULT_TEMPLATES,
                     loss_impl: Optional[str] = None,
                     device=None, mesh=None, axes=None) -> dict:
    """End-to-end eval through the planted closed-form towers (params as
    restored from a ``make_planted_checkpoint`` checkpoint, on
    ``device``, default the card): the metrics must equal
    ``planted.known_answers(dataset)`` exactly, with or without the
    sharded retrieval (``mesh`` + ``axes``)."""
    e1n, e2n = EX.extract_pair_embeddings(
        PL.encode_pair, params, dataset, batch_size=batch_size,
        device=device)
    head = CL.build_head(
        lambda t: PL.encode_text(params, t), dataset.tok_base,
        context_length=dataset.context_length, templates=templates,
        device=device)
    return evaluate_embeddings(
        e1n, e2n, dataset.labels, head, ks=ks, top_ks=top_ks, chunk=chunk,
        loss_impl=loss_impl, device=device, mesh=mesh, axes=axes)
