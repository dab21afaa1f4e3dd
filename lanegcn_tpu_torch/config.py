"""Typed configuration for the framework.

The reference keeps one module-level python dict per model file
(reference lanegcn.py:28-92, lanercnn.py:30-82). Here the same knob set is
expressed as frozen dataclasses so configs are hashable (usable as jit static
args) and self-documenting.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """LaneGCN model hyper-parameters (reference lanegcn.py:74-91)."""

    n_actor: int = 128
    n_map: int = 128
    num_scales: int = 6  # pre/suc dilations 1,2,4,8,16,32
    num_mods: int = 6
    num_preds: int = 30  # 30 future steps @ 10 Hz
    num_hist: int = 20   # 20 observed steps
    actor2map_dist: float = 7.0
    map2actor_dist: float = 6.0
    actor2actor_dist: float = 100.0
    num_fuse_layers: int = 4   # residual LaneConv blocks in MapNet / M2M
    num_att_layers: int = 2    # Att repetitions per fusion stage
    pred_range: Tuple[float, float, float, float] = (-100.0, 100.0, -100.0, 100.0)
    # The LaneConv layer (models/map_net.py LaneConvStack). "auto", "on" and
    # "interpret" (the JAX package's names, kept so one config reads in
    # both) run the fused layer: the band products and the layer tail in one
    # kernel (ops/lane_layer.py, csrc/lane_layer.cu). "off" runs the
    # unfused layer: the band sum as its own kernel (ops/band_conv.py,
    # csrc/band_conv.cu), then the tail as the row tail kernel
    # (ops/row_tail.py). A pack without band masks (split_bands=False)
    # always takes the unfused layer. Both layers hold the same parameters.
    pallas_bands: str = "auto"
    # Kept for configs written for the JAX package, which selects its
    # fusion edge MLP and window-plan backends with them; the port always
    # runs its kernels for both (ops/edge_mlp.py, ops/win_edge.py,
    # ops/scenario_agg.py) and reads neither field.
    pallas_edge: str = "auto"
    scenario_agg: str = "auto"
    # Run the window plan's aggregate inside the fused LaneConv layer kernel
    # (ops/lane_layer.fused_lane_layer_plan, csrc/lane_plan.cu) when the
    # node tile can be the window stride (stride >= 512, the plan's slots
    # per window a chunk multiple); "off" runs scenario_agg and the layer
    # kernel apart. On an NVIDIA H100 80GB HBM3 at 700 W the merged layer
    # took 0.939 of the separate kernels' device busy time per serve
    # forward and 0.977 per train step (PERF.md, chip_smoke.py `ab`). The
    # default stays "off", as in the JAX package.
    merge_plan_agg: str = "off"

    @property
    def num_relations(self) -> int:
        """pre0..pre{S-1}, suc0..suc{S-1}, left, right."""
        return 2 * self.num_scales + 2


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Joint classification + regression loss (reference lanegcn.py:87-91)."""

    cls_coef: float = 1.0
    reg_coef: float = 1.0
    mgn: float = 0.2
    cls_th: float = 2.0
    cls_ignore: float = 0.2


@dataclasses.dataclass(frozen=True)
class PackConfig:
    """Static capacities for one packed batch (one device's micro-batch).

    The reference batches by python lists of variable-size tensors
    (reference data.py:555-561); XLA needs static shapes, so scenarios are
    packed into fixed-capacity buffers with validity masks. Capacities are a
    compilation key — keep the set of distinct PackConfigs small (bucketing).
    """

    max_scenarios: int = 32     # scenarios per pack (= per-device batch)
    max_actors: int = 512       # total actors across the pack
    max_nodes: int = 8192       # total lane nodes across the pack
    max_edges_scale0: int = 8192   # per-relation capacity for pre0/suc0
    # Per-relation capacity for pre_i/suc_i, i>=1: one int for all dilated
    # scales, or a tuple of length num_scales-1 (scale i uses entry i-1 —
    # dilated edge counts grow ~2^i at junction fans, so per-scale sizing
    # avoids paying the largest scale's capacity on every scale).
    max_edges_dilated: Any = 8192
    max_edges_lr: int = 4096       # capacity for left/right
    max_a2m_edges: int = 16384
    max_m2a_edges: int = 16384
    max_a2a_edges: int = 8192
    # Capacity of the combined inverse edge list backing the neighbor-table
    # backward (the JAX package's ops.table_gather). 0 ⇒ auto (2 × max_nodes — exact upper
    # bound for the default left/right tabling: each node has at most one
    # left and one right neighbor). On overflow the packer demotes table
    # entries to the regular edge lists, so gradients stay exact either way.
    max_table_edges: int = 0
    # WINDOWED node layout: nodes are placed window-aligned first-fit into
    # fixed node_stride-row windows (a scenario lands inside one window when
    # it fits; oversize scenarios straddle). Enables the window edge plan
    # for ops/pallas_scenario_agg. Requires max_nodes % node_stride == 0.
    # None ⇒ contiguous packing (round-1/2 layout). Density cost is the
    # alignment gaps (~4-6% rows measured on urban packs at stride 768).
    node_stride: int | None = None
    # Per-window capacity of the window edge plan (overflow edges with both
    # endpoints in one window, routed to ops/pallas_scenario_agg; cross-
    # window edges and the residue past this budget stay in the classic
    # per-relation edge lists). 0 ⇒ no plan. Requires node_stride.
    max_plan_edges: int = 0
    # Relations routed to per-node neighbor tables (pack_batch split_tables;
    # left/right are functional so tables absorb them entirely). With the
    # window plan enabled, () routes left/right through the plan instead —
    # measured faster: the table backward was a 262k-row sorted scatter per
    # layer, the plan adds only one-hot matmul columns.
    table_relations: Tuple[str, ...] = ("left", "right")
    # WINDOWED actor layout (mirrors node_stride): actors are placed
    # window-aligned first-fit into actor_stride-row windows. Required for
    # the fusion pair plans. Requires max_actors % actor_stride == 0.
    actor_stride: int | None = None
    # Emit window-pair chunked fusion-edge plans (graph.PairPlan) for the
    # fused Att kernel (ops/pallas_win_edge). Requires node_stride +
    # actor_stride. Capacities are the max_*_edges knobs rounded down to
    # pair_chunk multiples; chunk-alignment padding means the same knob
    # admits fewer edges than the flat EdgeSet (size accordingly — overflow
    # drops edges with a dropped_pair_* counter, same policy as the lists).
    fusion_pairs: bool = False
    pair_chunk: int = 128
    # Route the window plan's residue (cross-window + over-budget overflow
    # edges) into a (dst-window, src-window) chunk-pair plan for
    # ops/pallas_pair_agg instead of the classic gather/scatter edge lists.
    # Requires node_stride + max_plan_edges; capacity in slots
    # (chunk-pair alignment padding included — size to measured residue).
    spill_pairs: bool = False
    max_spill_pair_edges: int = 49152

    @property
    def table_edge_capacity(self) -> int:
        return self.max_table_edges or 2 * self.max_nodes

    def edge_capacity(self, relation: str) -> int:
        if relation in ("left", "right"):
            return self.max_edges_lr
        if relation.startswith(("pre", "suc")):
            scale = int(relation[3:])
            if scale == 0:
                return self.max_edges_scale0
            med = self.max_edges_dilated
            if isinstance(med, (tuple, list)):
                return int(med[scale - 1])
            return med
        raise ValueError(f"unknown relation {relation!r}")


@dataclasses.dataclass(frozen=True)
class RoiPackConfig:
    """Static capacities for a LaneRCNN RoI pack (reference batch_size=10,
    lanercnn.py:49; each scenario contributes one RoI per moving agent)."""

    max_scenarios: int = 10
    max_rois: int = 128          # RoIs (valid agents) across the pack
    max_roi_nodes: int = 12288   # Σ RoI subgraph nodes
    max_interest_nodes: int = 2048  # Σ nodes of interest RoIs (decode)
    # Shared global lane graph capacity; 0 ⇒ max_roi_nodes (always enough —
    # every global node appears in ≥0 RoIs — but typically ~2x oversized:
    # the global graph is the union, RoI nodes are per-agent copies).
    max_global_nodes: int = 0
    max_edges_scale0: int = 16384
    max_edges_dilated: int = 20480
    max_edges_lr: int = 16384
    max_a2m_edges: int = 4096    # agent → RoI-node (≤5 m)
    max_pool_edges: int = 131072  # RoI-node ↔ global-node (≤6 m; ~10 per node)
    max_a2r_edges: int = 8192    # traj-point → interest-node (≤6 m)
    # Inverse-edge capacity for the RoI subgraphs' left/right neighbor
    # tables (the JAX package's ops.table_gather). 0 ⇒ 2 × max_roi_nodes (exact bound).
    max_table_edges: int = 0
    # WINDOWED layouts + window edge plan for ops/pallas_scenario_agg, as in
    # PackConfig: applies to BOTH the RoI-node space (scenario RoI blocks
    # placed first-fit into stride windows) and the shared global lane
    # graph (forwarded to its pack_batch). Requires max_roi_nodes and
    # max_global_nodes to be multiples of node_stride.
    node_stride: int | None = None
    max_plan_edges: int = 0
    # Stride for the global-graph window layout (defaults to node_stride).
    # The two spaces want different strides: RoIs are ~70-150 nodes (256
    # packs densely at RoI granularity), scenarios' global graphs ~700
    # (768 keeps them single-window).
    global_node_stride: int | None = None
    global_plan_edges: int = 0
    table_relations: Tuple[str, ...] = ("left", "right")
    # Chunk-align the pool edges (r2g/g2r) per destination window so the
    # LanePooling scatter runs via ops/pallas_window_scatter (one-hot MXU
    # matmuls). Alignment padding costs up to chunk-1 slots per occupied
    # destination window, so a max_pool_edges that fit the flat layout can
    # overflow here — the packer warns loudly when that drops edges; set
    # False to keep the flat destination-sorted layout. Only takes effect
    # with windowed layouts (node_stride set, capacity chunk-divisible).
    window_pool_edges: bool = True

    @property
    def g_stride(self):
        return self.global_node_stride or self.node_stride

    @property
    def g_plan_edges(self) -> int:
        return self.global_plan_edges or self.max_plan_edges

    @property
    def table_edge_capacity(self) -> int:
        return self.max_table_edges or 2 * self.max_roi_nodes

    def edge_capacity(self, relation: str) -> int:
        if relation in ("left", "right"):
            return self.max_edges_lr
        if relation.startswith(("pre", "suc")):
            scale = int(relation[3:])
            return self.max_edges_scale0 if scale == 0 else self.max_edges_dilated
        raise ValueError(f"unknown relation {relation!r}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training recipe (reference lanegcn.py:29-53, utils.py:98-177)."""

    opt: str = "adam"
    lr: Tuple[float, ...] = (1e-3, 1e-4)
    lr_epochs: Tuple[float, ...] = (32.0,)
    num_epochs: int = 36
    batch_size: int = 32          # scenarios per process
    weight_decay: float = 0.0
    clip_grads: bool = False
    clip_low: float = -1.0
    clip_high: float = 1.0
    save_freq: float = 1.0
    display_iters: int = 205942
    val_iters: int = 411884
    seed: int = 0
    # (param-path-prefix, coef) per-group lr scaling rules; first match wins,
    # unmatched params get 1.0 (reference Optimizer coef, utils.py:99-147).
    lr_coef: Tuple[Tuple[str, float], ...] = ()
    # Skip the optimizer update (params + moments bitwise unchanged) when the
    # loss or any gradient is non-finite. Failure detection the reference
    # lacks; a scalar select in the step, no host sync.
    nan_guard: bool = True


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    pack: PackConfig = PackConfig()
    roi_pack: RoiPackConfig = RoiPackConfig()
    train: TrainConfig = TrainConfig()


def windowed_pack_config(s: int) -> PackConfig:
    """One of the pack geometries the port serves: the production windowed layout
    (768-row node windows with a 2048-slot window plan, 128-row actor
    windows, fusion pair plans, no neighbour tables) with spill_pairs off,
    so the plan's residue rides the classic edge lists. Capacities scale
    with the s scenarios per pack, with max_edges_lr raised so urban
    scenarios drop no edge, and floors for small packs. The fusion pair
    plans hold 192·s (A2M), 160·s (M2A) and 72·s (A2A) slots, more than
    bench.py's 160·s and 64·s for A2M and A2A, which dropped A2M edges on a
    shuffled draw of 256 urban scenarios (`pack_draws.py` counts what
    shuffled draws need)."""
    return PackConfig(
        max_scenarios=s,
        max_actors=128 * (-(-16 * s // 128)),  # whole 128-row actor windows
        max_nodes=768 * (-(-s * 17 // 16)),
        node_stride=768,
        max_plan_edges=2048,
        table_relations=(),
        spill_pairs=False,
        max_edges_scale0=max(16 * s, 512),
        max_edges_dilated=tuple(max(8 * (2 ** i) * s, 512) for i in range(1, 6)),
        max_edges_lr=max(24 * s, 512),
        max_a2m_edges=max(192 * s, 4096),
        max_m2a_edges=max(160 * s, 4096),
        max_a2a_edges=max(72 * s, 2048),
        actor_stride=128,
        fusion_pairs=True,
    )


def bench_pack_config(s: int) -> PackConfig:
    """The layout of the JAX package's benchmark (bench.py
    `bench_pack_config`, without its environment overrides), with larger
    capacities where bench.py's dropped edges on shuffled draws of urban
    scenarios (`pack_draws.py` counts what such draws need): the windowed
    layout of `windowed_pack_config` with spill_pairs on, so the window
    plan's residue rides a (dst-window, src-window) chunk-pair plan of
    192·s slots and the classic lists keep only what overflows it: 512
    slots per relation, the dilated ones max(8·s, 512) (bench.py's 512
    overflowed once the spill plan did). max_actors is 16·s rounded up to
    whole 128-row actor windows, and the fusion pair plans are
    `windowed_pack_config`'s, with its floors for small packs (the
    max_actors and M2A capacities are bench.py's from s = 32 up; A2M and
    A2A are larger)."""
    return PackConfig(
        max_scenarios=s,
        max_actors=128 * (-(-16 * s // 128)),
        max_nodes=768 * (-(-s * 17 // 16)),
        node_stride=768,
        max_plan_edges=2048,
        table_relations=(),
        spill_pairs=True,
        max_spill_pair_edges=192 * s,
        max_edges_scale0=512,
        max_edges_dilated=(max(8 * s, 512),) * 5,
        max_edges_lr=512,
        max_a2m_edges=max(192 * s, 4096),
        max_m2a_edges=max(160 * s, 4096),
        max_a2a_edges=max(72 * s, 2048),
        actor_stride=128,
        fusion_pairs=True,
    )


def contiguous_pack_config(b: int) -> PackConfig:
    """The geometry the JAX package's CLI packs by default on one device
    (lanegcn_tpu/cli.py `_default_config`): contiguous nodes (no window
    plan), left/right neighbour tables, destination-sorted fusion edge
    lists (no pair plans), capacities scaled by the b scenarios per pack."""
    return PackConfig(
        max_scenarios=b,
        max_actors=16 * b,
        max_nodes=768 * b,
        max_edges_scale0=832 * b,
        max_edges_dilated=1024 * b,
        max_edges_lr=256 * b,
        max_a2m_edges=1024 * b,
        max_m2a_edges=1024 * b,
        max_a2a_edges=384 * b,
    )


def flat_pack_config(b: int) -> PackConfig:
    """The flat geometry: `contiguous_pack_config(b)` for packs built with
    pack_batch(split_bands=False, split_tables=False, scenario_plan=False),
    as the JAX package's CLI packs for its explicit graph-parallel path
    (lanegcn_tpu/cli.py `_pack_and_partition`). Without tables left/right
    ride the residue lists whole, so their lists hold 512·b slots (at the
    tabled layout's 256·b, 32 urban scenarios drop 20-40 % of them,
    tests/test_torch_band_conv.py); the other capacities are
    contiguous_pack_config's."""
    return dataclasses.replace(contiguous_pack_config(b), max_edges_lr=512 * b)


def lanercnn_pack_config(s: int) -> RoiPackConfig:
    """The LaneRCNN geometry the port serves: the layout of the JAX package's
    LaneRCNN benchmark (bench_lanercnn.py `bench_roi_config`, without its
    environment overrides). RoIs are bin-packed into 256-row windows with a
    512-slot window plan, the global lane graph into 768-row windows with a
    2048-slot plan, no neighbour tables, and the pool edges are
    window-chunked. At s = 256 the capacities equal the benchmark's, except
    the classic residue lists: they also carry the global graph's plan
    residue (measured maxima over 256 urban scenarios: 119 scale-0, 10,476
    dilated, 3,215 left/right edges), so they are sized to drop nothing
    (132,096 slots per LaneConv layer at s = 256). Small packs get floors so
    that they pack with zero drops too."""
    return RoiPackConfig(
        max_scenarios=s,
        max_rois=max(6 * s, 8 * min(s, 32), 96),
        max_roi_nodes=256 * (-(-max(384 * s, 512 * min(s, 16), 2048) // 256)),
        max_global_nodes=768 * (-(-s * 17 // 16)),
        max_interest_nodes=max(80 * s, 1024),
        node_stride=256,
        max_plan_edges=512,
        global_node_stride=768,
        global_plan_edges=2048,
        table_relations=(),
        max_edges_scale0=max(2 * s, 512),
        max_edges_dilated=max(48 * s, 96 * min(s, 64), 512),
        max_edges_lr=max(16 * s, 24 * min(s, 32), 512),
        max_a2m_edges=max(40 * s, 1024),
        max_pool_edges=max(4096 * s, 6144 * min(s, 32)),
        max_a2r_edges=max(192 * s, 2048),
    )


def relation_names(num_scales: int = 6) -> Tuple[str, ...]:
    """Edge-relation ordering used throughout: pre0..preS, suc0..sucS, left, right."""
    names = []
    for i in range(num_scales):
        names.append(f"pre{i}")
    for i in range(num_scales):
        names.append(f"suc{i}")
    names.extend(["left", "right"])
    return tuple(names)


def band_shift(name: str) -> int | None:
    """Packed-index stride of a relation's intra-lane band, or None.

    Lanes are contiguous node runs in pack order, so the intra-lane part of
    pre/suc at dilation 2^s is exactly v = u ∓ 2^s (pre points backward).
    left/right have no band structure.
    """
    if name.startswith("pre"):
        return -(1 << int(name[3:]))
    if name.startswith("suc"):
        return 1 << int(name[3:])
    return None
