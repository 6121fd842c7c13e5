"""The four optimizers benchmarked by the paper (port of
``repro.optim.optimizers``, Proc. 4): SGD with momentum, LAMB, Lion,
AdamW, with f32 moments.  Not ``torch.optim``: these follow the JAX math
step for step (the parity tests compare with it), including the f32
``1 - beta**t`` factors."""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer, tree_zeros_like


def _count(params):
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _bias_correction(beta: float, t: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.tensor(beta, dtype=torch.float32,
                              device=t.device) ** t.float()


# ---------------------------------------------------------------------------
# SGD with momentum (Polyak):  m = mu m + g + wd p ;  p -= lr m
# ---------------------------------------------------------------------------

def sgdm(mu=0.9):
    def init(params):
        return {"m": tree_zeros_like(params), "t": _count(params)}

    def update(params, grads, state, *, lr, wd=0.0):
        new_p, new_m = {}, {}
        for k, p in params.items():
            m = mu * state["m"][k] + grads[k].float() + wd * p.float()
            new_p[k] = (p - lr * m.to(p.dtype)).to(p.dtype)
            new_m[k] = m
        return new_p, {"m": new_m, "t": state["t"] + 1}

    return Optimizer("sgdm", init, update)


# ---------------------------------------------------------------------------
# AdamW (Loshchilov & Hutter 2019)
# ---------------------------------------------------------------------------

def adamw(beta1=0.9, beta2=0.999, eps=1e-8):
    def init(params):
        return {"m": tree_zeros_like(params), "v": tree_zeros_like(params),
                "t": _count(params)}

    def update(params, grads, state, *, lr, wd=0.0):
        t = state["t"] + 1
        bc1 = _bias_correction(beta1, t)
        bc2 = _bias_correction(beta2, t)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = beta1 * state["m"][k] + (1 - beta1) * g
            v = beta2 * state["v"][k] + (1 - beta2) * torch.square(g)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p.float()
            new_p[k] = (p - lr * step.to(p.dtype)).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v, "t": t}

    return Optimizer("adamw", init, update)


# ---------------------------------------------------------------------------
# Lion (Chen et al. 2023):
#   c = b1 m + (1-b1) g ;  m = b2 m + (1-b2) g ;  p -= lr (sign(c) + wd p)
# ---------------------------------------------------------------------------

def lion(beta1=0.9, beta2=0.99):
    def init(params):
        return {"m": tree_zeros_like(params), "t": _count(params)}

    def update(params, grads, state, *, lr, wd=0.0):
        new_p, new_m = {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = state["m"][k]
            c = beta1 * m + (1 - beta1) * g
            new_m[k] = beta2 * m + (1 - beta2) * g
            step = torch.sign(c) + wd * p.float()
            new_p[k] = (p - lr * step.to(p.dtype)).to(p.dtype)
        return new_p, {"m": new_m, "t": state["t"] + 1}

    return Optimizer("lion", init, update)


# ---------------------------------------------------------------------------
# LAMB (You et al. 2020), per-leaf trust ratio; alpha = 1 on leaves with
# ndim < 2 (norms, biases), as EVA-CLIP (paper App. B)
# ---------------------------------------------------------------------------

def lamb(beta1=0.9, beta2=0.999, eps=1e-6):
    def init(params):
        return {"m": tree_zeros_like(params), "v": tree_zeros_like(params),
                "t": _count(params)}

    def update(params, grads, state, *, lr, wd=0.0):
        t = state["t"] + 1
        bc1 = _bias_correction(beta1, t)
        bc2 = _bias_correction(beta2, t)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = beta1 * state["m"][k] + (1 - beta1) * g
            v = beta2 * state["v"][k] + (1 - beta2) * torch.square(g)
            r = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            upd = r + wd * p.float()
            if p.ndim >= 2:
                pn = torch.linalg.vector_norm(p.float())
                un = torch.linalg.vector_norm(upd)
                alpha = torch.where((pn > 0) & (un > 0),
                                    pn / torch.clamp_min(un, 1e-9), 1.0)
            else:
                alpha = 1.0
            new_p[k] = (p - lr * alpha * upd.to(p.dtype)).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v, "t": t}

    # the trust ratio norms the whole leaf
    return Optimizer("lamb", init, update, shard_safe=False)


OPTIMIZERS = {"adamw": adamw, "lamb": lamb, "lion": lion, "sgdm": sgdm}


def get_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)
