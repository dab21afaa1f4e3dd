"""Checkpoint save/restore (reference save_ckpt train.py:230-242,
load_pretrain utils.py:51-59), the port's counterpart of
lanegcn_tpu/train/checkpoint.py.

A checkpoint is one `torch.save` file of tensors and Python scalars only,
so `torch.load(weights_only=True)` reads it:

- `state_dict`: the net's reference-named tensors, cloned to the CPU;
- `epoch`: the fractional epoch;
- `flat_adam`: FusedAdam's `flat`, `mu`, `nu` and `count`, cloned to the CPU;
- `step`: the train step counter;
- `bf16`: whether the run computed in bfloat16, so that an eval of the
  checkpoint computes as the run's validation did.

`state_dict` and `epoch` are the reference's save_ckpt layout, so a port
checkpoint also loads where a reference checkpoint does (the CLI's
`--torch-weight`). Loads of weights are shape-checked partial restores like
the reference's load_pretrain: mismatched entries are skipped, not fatal.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import torch


def _cpu(t: torch.Tensor) -> torch.Tensor:
    """A compact CPU copy: a parameter is a view of the optimizer's flat
    buffer, and saving the view would save the whole buffer."""
    return t.detach().to("cpu", copy=True)


def save_checkpoint(path: str, net, state, epoch: float, bf16: bool = False) -> None:
    """Write `net`'s weights and `state` (a train.loop.TrainState) at the
    fractional `epoch`, trained in bfloat16 compute if `bf16`, to `path`,
    atomically: through path + ".tmp" and os.replace, so a preemption
    mid-write leaves the previous file whole."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    opt = state.opt
    payload = {
        "state_dict": {k: _cpu(v) for k, v in net.state_dict().items()},
        "epoch": float(epoch),
        "flat_adam": {"flat": _cpu(opt.flat), "mu": _cpu(opt.mu), "nu": _cpu(opt.nu),
                      "count": _cpu(opt.count)},
        "step": int(state.step),
        "bf16": bool(bf16),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # atomic → preemption-safe


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a checkpoint (or of a reference checkpoint holding
    `state_dict` and `epoch`), on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_pretrain(net, state_dict: Dict[str, torch.Tensor]) -> List[str]:
    """Shape-checked partial restore (reference utils.py:51-59): copy every
    entry of `state_dict` that `net` has with the same shape, in place (a
    parameter stays a view of the optimizer's flat buffer); returns the
    keys skipped, sorted."""
    own = net.state_dict()
    skipped = []
    with torch.no_grad():
        for k, v in state_dict.items():
            if k in own and own[k].shape == v.shape:
                own[k].copy_(v)
            else:
                skipped.append(k)
    return sorted(skipped)


def restore_train_state(state, payload: Dict[str, Any]) -> None:
    """The optimizer and the step counter of a checkpoint into `state`.

    `flat` is copied in place: the net's parameters are views of it, and a
    new tensor would cut them loose from the optimizer. FusedAdam.step
    replaces `mu`, `nu` and `count` each step, so they are restored as new
    tensors on `flat`'s device."""
    opt, saved = state.opt, payload["flat_adam"]
    if saved["flat"].shape != opt.flat.shape:
        raise ValueError(f"checkpoint holds {saved['flat'].numel()} optimizer parameters, "
                         f"the net {opt.flat.numel()}")
    dev = opt.flat.device
    with torch.no_grad():
        opt.flat.copy_(saved["flat"])
    opt.mu = saved["mu"].to(dev, copy=True)
    opt.nu = saved["nu"].to(dev, copy=True)
    opt.count = saved["count"].to(dev, copy=True)
    state.step = int(payload["step"])
