"""Optimizer + LR schedule with the reference's semantics (utils.py:98-177),
the port's counterpart of lanegcn_tpu/train/optimizer.py.

- StepLR: piecewise-constant lr as a function of the *fractional* epoch,
  returned as a device scalar (a where-chain: no host sync).
- Adam over ONE flat fp32 buffer of all parameters (the JAX package's
  `_make_fused_adam`): optional elementwise gradient clip, the moments,
  bias correction with an int32 count, optional weight decay added to the
  direction (u = m̂/(√n̂ + eps) + wd·p), the per-parameter lr coefficient,
  p ← p − lr·coef·u.
- lr coefficients: TrainConfig.lr_coef's (path-prefix, coef) rules, first
  match wins, matched against each parameter's flax path ('a/b/c') from the
  port's own name table of the net's family (utils/weights.py TABLES:
  LaneGCN's or LaneRCNN's), so one TrainConfig means the same in both
  packages; the 14 relation weights that split one stacked JAX leaf share
  its coefficient.
- The NaN guard: when the loss or any gradient is non-finite, params, the
  moments and the count stay bitwise unchanged (a select on the flat
  buffers, no `.item()`).

The parameters of the module become views into the flat buffer, so the
update is in place: the module's own tensors change.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from lanegcn_tpu_torch.config import TrainConfig


def step_lr(lrs: Sequence[float], boundaries: Sequence[float]) -> Callable:
    """Returns lr_fn(epoch, device) → fp32 scalar tensor on `device`:
    lrs[i] from boundaries[i-1] on (epoch compared in fp32, as in JAX)."""
    lrs = tuple(float(x) for x in lrs)
    boundaries = tuple(float(b) for b in boundaries)

    def lr_fn(epoch, device=None) -> torch.Tensor:
        if isinstance(epoch, torch.Tensor):
            e = epoch.to(device=device or epoch.device, dtype=torch.float32)
        else:
            e = torch.full((), float(epoch), dtype=torch.float32, device=device)
        lr = torch.full((), lrs[0], dtype=torch.float32, device=e.device)
        for b, l in zip(boundaries, lrs[1:]):
            lr = torch.where(e >= b, torch.full_like(lr, l), lr)
        return lr

    return lr_fn


def flax_paths(net) -> Dict[str, str]:
    """Torch parameter name → the flax path ('a/b/c') of the JAX leaf it
    comes from, from the weight table of the net's family (`net.family`:
    "lanegcn" or "lanercnn")."""
    from lanegcn_tpu_torch.utils.weights import TABLES

    return {tkey: "/".join(fpath) for tkey, fpath, _, _ in TABLES[net.family](net.cfg)}


def coef_of(path: str, rules: Sequence[Tuple[str, float]]) -> float:
    for prefix, c in rules:
        if path.startswith(prefix):
            return float(c)
    return 1.0


B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam's defaults, as in the JAX step


class FusedAdam:
    """Adam (+ AdamW-style decay in the direction) on one flat fp32 buffer.

    `named_params` are the module's (name, parameter) pairs; the parameters
    are rebound as views of `self.flat`. `step(lr, loss)` reads each
    parameter's `.grad` (None counts as zeros) and updates in place; it
    returns the guard's ok flag (a bool device scalar) when the guard is on,
    else None.
    """

    def __init__(self, named_params, wd: float = 0.0, clip: Tuple[float, float] | None = None,
                 coefs: Dict[str, float] | None = None, guard: bool = True):
        self.names, self.params = zip(*named_params)
        with torch.no_grad():
            self.flat = torch.cat([p.detach().reshape(-1).float() for p in self.params])
            off = 0
            for p in self.params:
                n = p.numel()
                p.data = self.flat[off:off + n].view_as(p)
                off += n
        self.wd, self.clip, self.guard = wd, clip, guard
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int32, device=self.flat.device)
        self.coef = None
        if coefs:
            self.coef = torch.cat([
                torch.full((p.numel(),), coefs.get(nm, 1.0), dtype=torch.float32)
                for nm, p in zip(self.names, self.params)]).to(self.flat.device)

    def _flat_grad(self) -> torch.Tensor:
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
            for p in self.params])

    @torch.no_grad()
    def step(self, lr: torch.Tensor, loss: torch.Tensor | None = None):
        g = self._flat_grad()
        ok = None
        if self.guard:
            ok = torch.isfinite(g).all()
            if loss is not None:
                ok = ok & torch.isfinite(loss.detach().float())
        if self.clip is not None:
            g = g.clamp(self.clip[0], self.clip[1])
        count = self.count + 1
        mu = B1 * self.mu + (1 - B1) * g
        nu = B2 * self.nu + (1 - B2) * g.square()
        c = count.float()
        mhat = mu / (1 - torch.pow(B1, c))
        nuhat = nu / (1 - torch.pow(B2, c))
        u = mhat / (nuhat.sqrt() + EPS)
        if self.wd:
            u = u + self.wd * self.flat
        if self.coef is not None:
            u = u * self.coef
        new = self.flat - lr * u
        if ok is not None:
            new = torch.where(ok, new, self.flat)
            mu = torch.where(ok, mu, self.mu)
            nu = torch.where(ok, nu, self.nu)
            count = torch.where(ok, count, self.count)
        self.flat.copy_(new)
        self.mu, self.nu, self.count = mu, nu, count
        return ok


def make_optimizer(cfg: TrainConfig, net) -> Tuple[FusedAdam, Callable]:
    """The flat Adam over `net`'s parameters and the lr schedule."""
    lr_fn = step_lr(cfg.lr, cfg.lr_epochs)
    if cfg.opt not in ("adam", "adamw"):
        if cfg.opt == "sgd":
            raise NotImplementedError("opt='sgd' (trace 0.9) is not ported yet; use 'adam'")
        raise ValueError(f"unknown optimizer {cfg.opt!r}")
    wd = cfg.weight_decay if cfg.opt == "adam" else (cfg.weight_decay or 0.01)
    clip = (cfg.clip_low, cfg.clip_high) if cfg.clip_grads else None
    coefs = None
    if cfg.lr_coef:
        paths = flax_paths(net)
        coefs = {name: coef_of(paths[name], cfg.lr_coef) for name, _ in net.named_parameters()}
    opt = FusedAdam(list(net.named_parameters()), wd=wd or 0.0, clip=clip, coefs=coefs,
                    guard=cfg.nan_guard)
    return opt, lr_fn
