"""Weight bridge: JAX LaneGCN and LaneRCNN params → the port's state_dicts.

The port's module tree uses the reference torch LaneGCN's names (for
example `map_net.fuse.pre0.3.weight`, `a2m.att.1.ctx.0.linear.weight`), so
a state_dict keyed by the reference names loads with
`load_state_dict(strict=True)`: that is the whole bridge, and a published
reference checkpoint's state_dict would load the same way.

The name/layout tables below are the port's own copies of the JAX
package's (lanegcn_tpu/utils/torch_import.py `lanegcn_table`,
`lanercnn_table`): Dense kernels [in, out] become
Linear weights [out, in]; conv kernels [k, in, out] become [out, in, k]
and 2-D ones (HWIO [k, k, in, out], `block_table`) [out, in, k, k];
norm vectors copy; the stacked relation kernel [R, C, C] splits into the
14 per-relation Linear weights.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from lanegcn_tpu_torch.config import ModelConfig, relation_names
from lanegcn_tpu_torch.models.layers import Conv2dBlock, EncodeDist, PostRes

# transform kinds
_LIN = "linear"      # torch [out, in]      → flax [in, out]
_CONV = "conv1d"     # torch [out, in, k]   → flax [k, in, out]
_CONV2D = "conv2d"   # torch [out, in, k, k] → flax HWIO [k, k, in, out]
_COPY = "copy"       # identical layout (norm vectors, biases)

# An entry maps one torch key to one flax leaf (path tuple) — or, for the
# stacked relation kernels, to a slice (path, relation_index).
Entry = Tuple[str, Tuple[str, ...], str, int | None]


def _norm(t: str, f: Tuple[str, ...]) -> List[Entry]:
    return [
        (f"{t}.weight", f + ("weight",), _COPY, None),
        (f"{t}.bias", f + ("bias",), _COPY, None),
    ]


def _dense(t: str, f: Tuple[str, ...], bias: bool = True) -> List[Entry]:
    out = [(f"{t}.weight", f + ("kernel",), _LIN, None)]
    if bias:
        out.append((f"{t}.bias", f + ("bias",), _COPY, None))
    return out


def _linear_block(t: str, f: Tuple[str, ...]) -> List[Entry]:
    """Reference layers.Linear (linear + norm) → our Linear submodule."""
    return _dense(f"{t}.linear", f + ("linear",), bias=False) + _norm(f"{t}.norm", f + ("norm",))


def _linear_res(t: str, f: Tuple[str, ...], transform: bool = False) -> List[Entry]:
    """Reference layers.LinearRes → our LinearRes (reference layers.py:193-238)."""
    out = (
        _dense(f"{t}.linear1", f + ("linear1",), bias=False)
        + _norm(f"{t}.norm1", f + ("norm1",))
        + _dense(f"{t}.linear2", f + ("linear2",), bias=False)
        + _norm(f"{t}.norm2", f + ("norm2",))
    )
    if transform:
        out += _dense(f"{t}.transform.0", f + ("transform_linear",), bias=False)
        out += _norm(f"{t}.transform.1", f + ("transform_norm",))
    return out


def _res1d(t: str, f: Tuple[str, ...], downsample: bool) -> List[Entry]:
    """Reference layers.Res1d → our Res1d (reference layers.py:142-190)."""
    out = [
        (f"{t}.conv1.weight", f + ("conv1_kernel",), _CONV, None),
        (f"{t}.conv2.weight", f + ("conv2_kernel",), _CONV, None),
    ]
    out += _norm(f"{t}.bn1", f + ("bn1",)) + _norm(f"{t}.bn2", f + ("bn2",))
    if downsample:
        out.append((f"{t}.downsample.0.weight", f + ("downsample_kernel",), _CONV, None))
        out += _norm(f"{t}.downsample.1", f + ("downsample_norm",))
    return out


def _att(t: str, f: Tuple[str, ...]) -> List[Entry]:
    """Reference Att (lanegcn.py:634-710) → our fusion.Att.

    The ctx MLP consumes concat([dist, query, ctx]) — our SplitLinear
    ``ctx_hidden`` holds the same [3C, n_agt] kernel with identical segment
    order, so the mapping is a plain transpose.
    """
    return (
        _dense(f"{t}.dist.0", f + ("dist_dense",))
        + _linear_block(f"{t}.dist.2", f + ("dist_out",))
        + _linear_block(f"{t}.query", f + ("query",))
        + _linear_block(f"{t}.ctx.0", f + ("ctx_hidden",))
        + _dense(f"{t}.ctx.1", f + ("ctx_out",), bias=False)
        + _dense(f"{t}.agt", f + ("agt",), bias=False)
        + _norm(f"{t}.norm", f + ("norm",))
        + _linear_block(f"{t}.linear", f + ("linear",))
    )


def _fuse_stack(t: str, f: Tuple[str, ...], num_scales: int, layers: int) -> List[Entry]:
    """Reference MapNet/M2M fuse ModuleDict (lanegcn.py:289-308) → our
    LaneConvStack: per-relation nn.Linear weights become slices of the
    stacked ``rel_kernel_{i}`` [R, C, C]."""
    names = relation_names(num_scales)
    out: List[Entry] = []
    for i in range(layers):
        out.append((f"{t}.ctr.{i}.weight", f + (f"ctr_{i}", "kernel"), _LIN, None))
        for r, name in enumerate(names):
            out.append((f"{t}.{name}.{i}.weight", f + (f"rel_kernel_{i}",), _LIN, r))
        out += _norm(f"{t}.norm.{i}", f + (f"norm_{i}",))
        out += _linear_block(f"{t}.ctr2.{i}", f + (f"ctr2_{i}",))
    return out


def lanegcn_table(cfg: ModelConfig) -> List[Entry]:
    """Full LaneGCN Net mapping (reference lanegcn.py:94-151 module tree)."""
    entries: List[Entry] = []

    # ActorNet (reference lanegcn.py:212-263): 3 groups × 2 Res1d blocks;
    # block 0 of each group changes width (and strides for groups 1-2) so it
    # carries a downsample path; block 1 never does.
    for g in range(3):
        entries += _res1d(f"actor_net.groups.{g}.0", ("actor_net", f"group{g}_block0"), True)
        entries += _res1d(f"actor_net.groups.{g}.1", ("actor_net", f"group{g}_block1"), False)
    for i in range(3):
        entries.append(
            (f"actor_net.lateral.{i}.conv.weight", ("actor_net", f"lateral{i}", "kernel"), _CONV, None)
        )
        entries += _norm(f"actor_net.lateral.{i}.norm", ("actor_net", f"lateral{i}", "norm"))
    entries += _res1d("actor_net.output", ("actor_net", "output"), False)

    # MapNet (lanegcn.py:266-363): input/seg embeds + fuse stack.
    entries += _dense("map_net.input.0", ("map_net", "input_dense"))
    entries += _linear_block("map_net.input.2", ("map_net", "input_out"))
    entries += _dense("map_net.seg.0", ("map_net", "seg_dense"))
    entries += _linear_block("map_net.seg.2", ("map_net", "seg_out"))
    entries += _fuse_stack("map_net.fuse", ("map_net", "fuse"), cfg.num_scales, cfg.num_fuse_layers)

    # A2M (lanegcn.py:366-407): meta Linear + 2 Att.
    entries += _linear_block("a2m.meta", ("a2m", "meta"))
    for i in range(cfg.num_att_layers):
        entries += _att(f"a2m.att.{i}", ("a2m", f"att{i}"))

    # M2M (lanegcn.py:410-480): bare fuse stack.
    entries += _fuse_stack("m2m.fuse", ("m2m", "fuse"), cfg.num_scales, cfg.num_fuse_layers)

    # M2A / A2A (lanegcn.py:483-545): 2 Att each.
    for mod in ("m2a", "a2a"):
        for i in range(cfg.num_att_layers):
            entries += _att(f"{mod}.att.{i}", (mod, f"att{i}"))

    # PredNet (lanegcn.py:575-631).
    for m in range(cfg.num_mods):
        entries += _linear_res(f"pred_net.pred.{m}.0", ("pred_net", f"pred{m}_res"))
        entries += _dense(f"pred_net.pred.{m}.1", ("pred_net", f"pred{m}_out"))
    entries += _dense("pred_net.att_dest.dist.0", ("pred_net", "att_dest", "dist_dense"))
    entries += _linear_block("pred_net.att_dest.dist.2", ("pred_net", "att_dest", "dist_out"))
    entries += _linear_block("pred_net.att_dest.agt", ("pred_net", "att_dest", "agt"))
    entries += _linear_res("pred_net.cls.0", ("pred_net", "cls_res"))
    entries += _dense("pred_net.cls.1", ("pred_net", "cls_out"))
    return entries


def _pooling(t: str, f: Tuple[str, ...]) -> List[Entry]:
    """Reference LanePooling (lanercnn.py:433-514) → our models.lanercnn
    LanePooling. ctx.0 consumes concat([ctx_feat, relpose]) (lanercnn.py:499);
    the tail is norm (GN1) → mlp.0 (linear and GN2) → mlp.1 (linear and GN3)."""
    return (
        _dense(f"{t}.input", f + ("input",), bias=False)
        + _dense(f"{t}.relpose.0", f + ("relpose",))
        + _linear_block(f"{t}.ctx.0", f + ("ctx_hidden",))
        + _dense(f"{t}.ctx.1", f + ("ctx_out",), bias=False)
        + _linear_block(f"{t}.mlp.0", f + ("mlp1",))
        + _linear_block(f"{t}.mlp.1", f + ("mlp2",))
        + _norm(f"{t}.norm", f + ("norm",))
    )


def lanercnn_table(cfg: ModelConfig) -> List[Entry]:
    """Full LaneRCNN Net mapping (reference lanercnn.py:85-119 module tree:
    input → roi_net1 → interactor → roi_net2 → decode)."""
    entries: List[Entry] = []

    # LaneInput (lanercnn.py:280-351).
    entries.append(("input.map_fc.weight", ("input", "map_fc", "kernel"), _LIN, None))
    entries.append(("input.agt_fc.weight", ("input", "agt_fc", "kernel"), _LIN, None))
    entries += _norm("input.bn", ("input", "bn"))

    # roi_net1 / roi_net2 (lanercnn.py:354-430): input Linear + fuse stack.
    for mod in ("roi_net1", "roi_net2"):
        entries += _linear_block(f"{mod}.input", (mod, "input"))
        entries += _fuse_stack(f"{mod}.fuse", (mod, "fuse"), cfg.num_scales, cfg.num_fuse_layers)

    # Interactor (lanercnn.py:603-642): embeds + 2 poolings + global stack.
    entries += _dense("interactor.input.0", ("interactor", "input_dense"))
    entries += _linear_block("interactor.input.2", ("interactor", "input_out"))
    entries += _dense("interactor.seg.0", ("interactor", "seg_dense"))
    entries += _linear_block("interactor.seg.2", ("interactor", "seg_out"))
    entries += _pooling("interactor.roi2graph", ("interactor", "roi2graph"))
    entries += _fuse_stack("interactor.global_graph_net.fuse", ("interactor", "global_graph"),
                           cfg.num_scales, cfg.num_fuse_layers)
    entries += _pooling("interactor.graph2roi", ("interactor", "graph2roi"))

    # Decode (lanercnn.py:740-924).
    entries += _linear_block("decode.pred.0", ("decode", "pred_hidden"))
    entries += _dense("decode.pred.1", ("decode", "pred_out"))
    entries += _dense("decode.agt_layer1.0", ("decode", "agt1_dense"))
    entries += _linear_block("decode.agt_layer1.2", ("decode", "agt1_out"))
    entries += _dense("decode.agt_layer2.0", ("decode", "agt2_dense"))
    entries += _linear_block("decode.agt_layer2.2", ("decode", "agt2_out"))
    entries += _pooling("decode.lane_pool", ("decode", "lane_pool"))
    entries += _linear_block("decode.refinement.0", ("decode", "refine_hidden"))
    entries += _dense("decode.refinement.1", ("decode", "refine_out"))
    return entries


def pred_head_table(cfg: ModelConfig) -> List[Entry]:
    """LaneRCNN's standalone PredHead (models.lanercnn, JAX `hidden`/`out`)."""
    return _linear_block("pred.0", ("hidden",)) + _dense("pred.1", ("out",))


def refine_head_table(cfg: ModelConfig) -> List[Entry]:
    """LaneRCNN's standalone RefineHead (models.lanercnn, JAX `hidden`/`out`)."""
    return _linear_block("refinement.0", ("hidden",)) + _dense("refinement.1", ("out",))


def _conv2d_block(pre: str, f: Tuple[str, ...]) -> List[Entry]:
    """Reference layers.Conv2d → Conv2dBlock (`kernel` HWIO, `norm`)."""
    return ([(f"{pre}conv.weight", f + ("kernel",), _CONV2D, None)]
            + _norm(f"{pre}norm", f + ("norm",)))


def _post_res(pre: str, f: Tuple[str, ...], downsample: bool) -> List[Entry]:
    """Reference layers.PostRes → PostRes (conv1/conv2 kernels HWIO, bn1, bn2,
    and the 1x1 downsample where the block has one)."""
    out = [(f"{pre}conv1.weight", f + ("conv1_kernel",), _CONV2D, None),
           (f"{pre}conv2.weight", f + ("conv2_kernel",), _CONV2D, None)]
    out += _norm(f"{pre}bn1", f + ("bn1",)) + _norm(f"{pre}bn2", f + ("bn2",))
    if downsample:
        out.append((f"{pre}downsample.0.weight", f + ("downsample_kernel",), _CONV2D, None))
        out += _norm(f"{pre}downsample.1", f + ("downsample_norm",))
    return out


def _encode_dist(pre: str, f: Tuple[str, ...], linear: bool) -> List[Entry]:
    """Reference EncodeDist (block.0, block.2) → EncodeDist (`dense`, `out`)."""
    out = _dense(f"{pre}block.0", f + ("dense",))
    return out + (_dense(f"{pre}block.2", f + ("out",)) if linear else [])


def block_table(block: torch.nn.Module) -> List[Entry]:
    """The entries of one of models.layers' raster-path and distance blocks
    (Conv2dBlock, PostRes, EncodeDist) as a module of its own; which
    entries exist follows the block (PostRes's downsample, EncodeDist's
    `linear`)."""
    if isinstance(block, Conv2dBlock):
        return _conv2d_block("", ())
    if isinstance(block, PostRes):
        return _post_res("", (), block.downsample is not None)
    if isinstance(block, EncodeDist):
        return _encode_dist("", (), len(block.block) == 3)
    raise TypeError(f"no weight table for {type(block).__name__}")


TABLES = {"lanegcn": lanegcn_table, "lanercnn": lanercnn_table,
          "pred_head": pred_head_table, "refine_head": refine_head_table}


def _to_torch(value: np.ndarray, kind: str) -> np.ndarray:
    if kind == _LIN:
        return np.ascontiguousarray(value.T)
    if kind == _CONV:
        return np.ascontiguousarray(value.transpose(2, 1, 0))
    if kind == _CONV2D:
        return np.ascontiguousarray(value.transpose(3, 2, 0, 1))
    return np.asarray(value)


def _get_leaf(tree: Dict, path: Tuple[str, ...]):
    node = tree
    for key in path:
        node = node[key]
    return node


def _export(params: Dict, entries: List[Entry]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for tkey, fpath, kind, rel in entries:
        leaf = np.asarray(_get_leaf(params, fpath), np.float32)
        if rel is not None:
            leaf = leaf[rel]
        out[tkey] = _to_torch(leaf, kind)
    return out


def export_state_dict(params: Dict, cfg: ModelConfig,
                      model: str = "lanegcn") -> Dict[str, np.ndarray]:
    """JAX params (nested dict of arrays) of `model` (a key of TABLES) →
    reference-named state_dict (numpy, torch layouts)."""
    return _export(params, TABLES[model](cfg))


def load_jax_params(net: torch.nn.Module, params: Dict, cfg: ModelConfig,
                    model: str = "lanegcn") -> None:
    """Copy JAX params into the port's LaneGCN, LaneRCNN or one of
    LaneRCNN's standalone heads (`model`, a key of TABLES; strict: every
    name and shape must match)."""
    sd = {k: torch.tensor(v) for k, v in export_state_dict(params, cfg, model).items()}
    net.load_state_dict(sd, strict=True)


def load_block_params(block: torch.nn.Module, params: Dict) -> None:
    """Copy the flax params of a Conv2dBlock, PostRes or EncodeDist into the
    port's block of the same shape (strict, `block_table`)."""
    sd = {k: torch.tensor(v) for k, v in _export(params, block_table(block)).items()}
    block.load_state_dict(sd, strict=True)
