"""Optimizer + LR schedule with the reference's semantics (utils.py:98-177),
the port's counterpart of lanegcn_tpu/train/optimizer.py.

- StepLR: piecewise-constant lr as a function of the *fractional* epoch,
  returned as a device scalar (a where-chain: no host sync).
- Adam over ONE flat fp32 buffer of all parameters (the JAX package's
  `_make_fused_adam`): optional elementwise gradient clip, the moments,
  bias correction with an int32 count, optional weight decay added to the
  direction (u = m̂/(√n̂ + eps) + wd·p), the per-parameter lr coefficient,
  p ← p − lr·coef·u.
- SGD on the same flat buffer (the JAX package's optax chain for
  opt="sgd"): the elementwise clip, then a trace with decay 0.9
  (t ← g + 0.9·t, optax.trace), then the lr coefficient, p ← p − lr·coef·t.
  Like the JAX chain it takes no weight decay.
- lr coefficients: TrainConfig.lr_coef's (path-prefix, coef) rules, first
  match wins, matched against each parameter's flax path ('a/b/c') from the
  port's own name table of the net's family (utils/weights.py TABLES:
  LaneGCN's or LaneRCNN's), so one TrainConfig means the same in both
  packages; the 14 relation weights that split one stacked JAX leaf share
  its coefficient.
- The NaN guard: when the loss or any gradient is non-finite, params and
  the optimizer's state stay bitwise unchanged (a select on the flat
  buffers, no `.item()`).
- A step may be handed a `reduce` callable, applied to the flat gradient
  before the guard and the update: the mesh's gradient mean
  (parallel/windowed_parallel.py), so every rank judges and applies the
  same gradient.

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
TRACE_DECAY = 0.9  # optax.trace(decay=0.9), the JAX chain's SGD momentum


class FlatOptimizer:
    """An update rule on one flat fp32 buffer of all parameters.

    `named_params` are the module's (name, parameter) pairs; the parameters
    are rebound as views of `self.flat`. `step(lr, loss, reduce)` reads each
    parameter's `.grad` (None counts as zeros), applies `reduce` to the flat
    gradient when given, and updates in place; it returns the guard's ok
    flag (a bool device scalar) when the guard is on, else None.

    A subclass names its state tensors in STATE (each replaced, not
    updated in place, by a step) and the checkpoint key they are saved
    under in KEY, and computes the direction in `_direction`.
    """

    STATE: Tuple[str, ...] = ()
    KEY = ""

    def __init__(self, named_params, clip: Tuple[float, float] | None = None,
                 coefs: Dict[str, float] | None = None, guard: bool = True):
        self.names, self.params = zip(*named_params)
        with torch.no_grad():
            self.flat = torch.cat([p.detach().reshape(-1).float() for p in self.params])
            off = 0
            for p in self.params:
                n = p.numel()
                p.data = self.flat[off:off + n].view_as(p)
                off += n
        self.clip, self.guard = clip, guard
        self.coef = None
        if coefs:
            self.coef = torch.cat([
                torch.full((p.numel(),), coefs.get(nm, 1.0), dtype=torch.float32)
                for nm, p in zip(self.names, self.params)]).to(self.flat.device)

    def _flat_grad(self) -> torch.Tensor:
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
            for p in self.params])

    def state(self) -> Dict[str, torch.Tensor]:
        """The flat parameters and the optimizer's state, by name."""
        return {"flat": self.flat, **{k: getattr(self, k) for k in self.STATE}}

    def _direction(self, g: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(u, new state) for the clipped gradient g: p ← p − lr·coef·u."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, lr: torch.Tensor, loss: torch.Tensor | None = None,
             reduce: Callable[[torch.Tensor], torch.Tensor] | None = None):
        g = self._flat_grad()
        if reduce is not None:
            g = reduce(g)
        ok = None
        if self.guard:
            ok = torch.isfinite(g).all()
            if loss is not None:
                ok = ok & torch.isfinite(loss.detach().float())
        if self.clip is not None:
            g = g.clamp(self.clip[0], self.clip[1])
        u, new = self._direction(g)
        if self.coef is not None:
            u = u * self.coef
        flat = self.flat - lr * u
        if ok is not None:
            flat = torch.where(ok, flat, self.flat)
            new = {k: torch.where(ok, v, getattr(self, k)) for k, v in new.items()}
        self.flat.copy_(flat)
        for k, v in new.items():
            setattr(self, k, v)
        return ok


class FusedAdam(FlatOptimizer):
    """Adam (+ AdamW-style decay in the direction) on the flat buffer."""

    STATE = ("mu", "nu", "count")
    KEY = "flat_adam"

    def __init__(self, named_params, wd: float = 0.0, clip: Tuple[float, float] | None = None,
                 coefs: Dict[str, float] | None = None, guard: bool = True):
        super().__init__(named_params, clip=clip, coefs=coefs, guard=guard)
        self.wd = wd
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int32, device=self.flat.device)

    def _direction(self, g):
        count = self.count + 1
        mu = B1 * self.mu + (1 - B1) * g
        nu = B2 * self.nu + (1 - B2) * g.square()
        c = count.float()
        mhat = mu / (1 - torch.pow(B1, c))
        nuhat = nu / (1 - torch.pow(B2, c))
        u = mhat / (nuhat.sqrt() + EPS)
        if self.wd:
            u = u + self.wd * self.flat
        return u, {"mu": mu, "nu": nu, "count": count}


class FusedSGD(FlatOptimizer):
    """SGD with the JAX chain's trace (momentum 0.9) on the flat buffer."""

    STATE = ("trace",)
    KEY = "flat_sgd"

    def __init__(self, named_params, clip: Tuple[float, float] | None = None,
                 coefs: Dict[str, float] | None = None, guard: bool = True):
        super().__init__(named_params, clip=clip, coefs=coefs, guard=guard)
        self.trace = torch.zeros_like(self.flat)

    def _direction(self, g):
        trace = g + TRACE_DECAY * self.trace
        return trace, {"trace": trace}


def make_optimizer(cfg: TrainConfig, net) -> Tuple[FlatOptimizer, Callable]:
    """The flat optimizer over `net`'s parameters (Adam, AdamW or SGD, as
    cfg.opt names it) and the lr schedule."""
    lr_fn = step_lr(cfg.lr, cfg.lr_epochs)
    if cfg.opt not in ("adam", "adamw", "sgd"):
        raise ValueError(f"unknown optimizer {cfg.opt!r}")
    clip = (cfg.clip_low, cfg.clip_high) if cfg.clip_grads else None
    coefs = None
    if cfg.lr_coef:
        paths = flax_paths(net)
        coefs = {name: coef_of(paths[name], cfg.lr_coef) for name, _ in net.named_parameters()}
    params = list(net.named_parameters())
    if cfg.opt == "sgd":
        return FusedSGD(params, clip=clip, coefs=coefs, guard=cfg.nan_guard), lr_fn
    wd = cfg.weight_decay if cfg.opt == "adam" else (cfg.weight_decay or 0.01)
    opt = FusedAdam(params, wd=wd or 0.0, clip=clip, coefs=coefs, guard=cfg.nan_guard)
    return opt, lr_fn
