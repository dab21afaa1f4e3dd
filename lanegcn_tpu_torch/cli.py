"""Command-line entry points: train / eval / preprocess, on one GPU.

The port's counterpart of lanegcn_tpu/cli.py (the reference's train.py,
test.py and preprocess_data.py CLIs, on the packed-batch pipeline), with
the same flags, log lines and checkpoint schedule. It runs on `cuda` unless
given `--device cpu`, and raises without CUDA otherwise. Examples:

    python -m lanegcn_tpu_torch.cli preprocess --data urban:512:7:16 --out shards/
    python -m lanegcn_tpu_torch.cli train --model lanegcn --data shards/ \\
        --val-data urban:64:7:16 --epochs 2 --bf16 --workers 2 --save-dir results/lanegcn
    python -m lanegcn_tpu_torch.cli eval --model lanegcn --data urban:64:7:16 \\
        --weight results/lanegcn/2.000.ckpt

A resumed run (`--resume CKPT`) restores the step counter and skips the
groups of the current epoch that were already trained, without fetching or
packing them, so it ends bitwise where the run that was never stopped ends.
The mesh and multi-process flags of the JAX CLI (--mesh, --graph-parallel,
--edge-shard-slack, --dist-*) are not ported yet.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import pickle
import sys
import time

import numpy as np
import torch

from lanegcn_tpu_torch.train.preempt import PreemptionGuard


def _parse_data(spec: str, model: str = "lanegcn"):
    """'synthetic:N[:corridors:actors]' / 'urban:N[:corridors:actors]'
    (junction-rich graphs) or a shard directory path."""
    from lanegcn_tpu_torch.data.dataset import (
        RoiSyntheticDataset,
        ShardDataset,
        SyntheticDataset,
    )

    if spec.startswith(("synthetic", "urban")):
        parts = spec.split(":")
        n = int(parts[1]) if len(parts) > 1 else 256
        cor = int(parts[2]) if len(parts) > 2 else 3
        act = int(parts[3]) if len(parts) > 3 else 12
        cls = RoiSyntheticDataset if model == "lanercnn" else SyntheticDataset
        return cls(n, num_corridors=cor, num_actors=act, urban=spec.startswith("urban"))
    return ShardDataset(spec)


def _make_loader(dataset, config, model: str, **kw):
    """Model-family-aware loader: LaneRCNN uses the RoI packer."""
    from lanegcn_tpu_torch.data.dataset import PackedLoader

    if model == "lanercnn":
        from lanegcn_tpu_torch.data.packing_roi import pack_roi_batch

        kw.setdefault(
            "packer",
            lambda scens, cfg: pack_roi_batch(scens, cfg.roi_pack, cfg.model),
        )
        kw.setdefault("scen_per_pack", config.roi_pack.max_scenarios)
    return PackedLoader(dataset, config, **kw)


def _default_config(args):
    """The JAX CLI's packs for b = --batch-size scenarios: LaneGCN's is
    contiguous_pack_config(b) (contiguous nodes, left/right tables, flat
    fusion lists), LaneRCNN's the same RoiPackConfig capacities (flat RoI
    and global node spaces, flat pool edges)."""
    from lanegcn_tpu_torch.config import (
        Config,
        RoiPackConfig,
        TrainConfig,
        contiguous_pack_config,
    )

    b = args.batch_size
    roi_pack = RoiPackConfig(
        max_scenarios=b,
        max_rois=14 * b,
        max_roi_nodes=1280 * b,
        max_interest_nodes=224 * b,
        max_edges_scale0=1664 * b,
        max_edges_dilated=2048 * b,
        max_edges_lr=1664 * b,
        max_a2m_edges=448 * b,
        max_pool_edges=13312 * b,
        max_a2r_edges=896 * b,
    )
    train = TrainConfig(batch_size=b)
    if getattr(args, "seed", None) is not None:
        train = dataclasses.replace(train, seed=args.seed)
    return Config(pack=contiguous_pack_config(b), roi_pack=roi_pack, train=train)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def _snapshot_run(save_dir: str, config, device) -> None:
    """Provenance snapshot into save_dir/files: the package source (without
    build products) plus argv, the resolved config, the git rev, the torch
    version and the device name (the reference copies its *.py into
    save_dir, train.py:108-115)."""
    import json
    import shutil
    import subprocess

    files_dir = os.path.join(save_dir, "files")
    pkg_root = os.path.dirname(os.path.abspath(__file__))
    dst = os.path.join(files_dir, "lanegcn_tpu_torch")
    if os.path.isdir(dst):
        shutil.rmtree(dst)
    shutil.copytree(pkg_root, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.o", "*.pyc"))
    rev = None
    try:
        rev = subprocess.check_output(
            ["git", "-C", os.path.dirname(pkg_root), "rev-parse", "HEAD"],
            stderr=subprocess.DEVNULL, text=True,
        ).strip()
    except (OSError, subprocess.CalledProcessError):
        pass
    with open(os.path.join(files_dir, "run.json"), "w") as f:
        json.dump(
            {
                "argv": sys.argv,
                "config": dataclasses.asdict(config),
                "git_rev": rev,
                "torch": torch.__version__,
                "device": _device_name(device),
            },
            f, indent=2, default=str,
        )


@contextlib.contextmanager
def _tee(save_dir):
    """Mirror stdout into save_dir/log for the enclosed run."""
    if not save_dir:
        yield
        return
    from lanegcn_tpu_torch.utils.logger import TeeLogger

    os.makedirs(save_dir, exist_ok=True)
    tee = TeeLogger(os.path.join(save_dir, "log"))
    sys.stdout = tee
    try:
        yield
    finally:
        sys.stdout = tee.terminal
        tee.close()


def _drops(drop_stats: list) -> dict:
    """The packers' dropped_*, skipped_*, spilled_* and graph_dropped_*
    (LaneRCNN's global graph) counters of the stats the loader appended
    since the last call, summed; those stats are taken off the list (the
    workers only append to it)."""
    n = len(drop_stats)
    taken = drop_stats[:n]
    del drop_stats[:n]
    drops: dict = {}
    for st in taken:
        for k, v in st.items():
            if v and k.startswith(("dropped", "skipped", "spilled", "graph_dropped")):
                drops[k] = drops.get(k, 0) + v
    return drops


def cmd_train(args):
    from lanegcn_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    with _tee(args.save_dir):
        _train(args, device)


def _train(args, device):
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.train.checkpoint import (
        load_checkpoint,
        load_pretrain,
        restore_train_state,
        save_checkpoint,
    )
    from lanegcn_tpu_torch.train.loop import (
        MetricAccumulator,
        init_state,
        make_eval_step,
        make_train_step,
    )
    from lanegcn_tpu_torch.utils.profiling import trace_context

    config = _default_config(args)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    bundle = get_model(args.model, config, dtype=dtype, device=device)
    config = bundle.config  # model factories may adjust (e.g. AdamW)
    if args.save_dir:
        _snapshot_run(args.save_dir, config, device)
    dataset = _parse_data(args.data, args.model)
    if args.rot_aug:
        from lanegcn_tpu_torch.data.augment import RotationAugment

        dataset = RotationAugment(dataset, seed=config.train.seed)
    # Drop accounting: every packer stats dict lands here; the display
    # lines sum its drop counters (`_drops`), so capacity overflow shows in
    # the training log.
    drop_stats: list = []
    loader = _make_loader(
        dataset, config, args.model, shuffle=True, seed=config.train.seed,
        pack_workers=args.workers, drop_stats=drop_stats, to_device=True, device=device,
    )
    steps_per_epoch = loader.steps_per_epoch()
    net, state = init_state(config, net=bundle.net, device=device)
    start_epoch = 0.0
    if args.resume:
        ck = load_checkpoint(args.resume)
        load_pretrain(net, ck["state_dict"])
        start_epoch = float(ck["epoch"])
        if "flat_adam" in ck:
            restore_train_state(state, ck)
        else:  # a reference checkpoint: weights and epoch only
            state.step = int(round(start_epoch * steps_per_epoch))
        print(f"resumed from {args.resume} at epoch {start_epoch:.3f}")

    eval_step = make_eval_step(config, net, device, bundle.loss_fn, bundle.metrics_fn)
    train_step = make_train_step(config, net, state, device, bundle.loss_fn,
                                 bundle.metrics_fn)
    val_dataset = _parse_data(args.val_data, args.model) if args.val_data else None
    acc = MetricAccumulator()
    save_freq = args.save_freq if args.save_freq is not None else config.train.save_freq
    next_save = (int(start_epoch / save_freq) + 1) * save_freq if save_freq else None
    next_val = (
        (int(start_epoch / args.val_every) + 1) * args.val_every
        if (args.val_every and val_dataset is not None) else None
    )
    num_params = sum(p.numel() for p in net.parameters())
    print(f"model {args.model}: {num_params:,} params, "
          f"{steps_per_epoch} steps/epoch on {_device_name(device)}")
    last_val_step = -1
    profile = contextlib.ExitStack()
    profiling = False  # a trace is open (a run resumed past step 5 starts none)
    t0 = time.time()
    # The epoch and the groups in it that a resumed run has trained already.
    first_epoch, skip = divmod(state.step, steps_per_epoch)

    with PreemptionGuard() as guard, profile:  # closes an open trace on exit
        for epoch_i in range(first_epoch, args.epochs):
            for batch in loader.epoch(epoch_i, skip=skip if epoch_i == first_epoch else 0):
                if args.profile and state.step == 5:
                    profile.enter_context(trace_context(args.profile))
                    profiling = True
                epoch = state.step / steps_per_epoch
                metrics = train_step(batch, epoch)  # state.step += 1
                acc.update(metrics)
                step = state.step
                if profiling and step >= 10:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    profile.close()
                    profiling = False
                    print(f"wrote profiler trace to {args.profile}")
                if step % args.display_every == 0:
                    s = acc.summary()
                    drops = _drops(drop_stats)
                    print(
                        f"epoch {epoch:.3f} lr {float(metrics['lr']):.5f} "
                        f"loss {s['loss']:.4f} {s['cls']:.4f} {s['reg']:.4f}, "
                        f"ade1 {s['ade1']:.4f}, fde1 {s['fde1']:.4f}, "
                        f"ade {s['ade']:.4f}, fde {s['fde']:.4f}, "
                        f"time {time.time() - t0:.2f}"
                        + (f", dropped {drops}" if drops else "")
                    )
                    acc.reset()
                    t0 = time.time()
                epoch_now = step / steps_per_epoch
                if guard.triggered:
                    # Preempted: write a resumable checkpoint and exit cleanly
                    # (the reference would just die; --resume continues here).
                    if args.save_dir:
                        path = os.path.join(args.save_dir, "%3.3f.ckpt" % epoch_now)
                        save_checkpoint(path, net, state, epoch_now, args.bf16)
                        print(f"{guard.signal_name}: saved {path}, exiting")
                    else:
                        print(f"{guard.signal_name}: exiting")
                    return
                if next_save is not None and epoch_now >= next_save:
                    if args.save_dir:
                        path = os.path.join(args.save_dir, "%3.3f.ckpt" % epoch_now)
                        save_checkpoint(path, net, state, epoch_now, args.bf16)
                        print(f"saved {path}")
                    next_save += save_freq
                if next_val is not None and epoch_now >= next_val:
                    _run_eval(config, bundle, val_dataset, eval_step, device=device)
                    last_val_step = step
                    next_val += args.val_every

    if val_dataset is not None and last_val_step != state.step:
        _run_eval(config, bundle, val_dataset, eval_step, device=device)


def _run_eval(config, bundle, dataset, eval_step, submission=None, device=None):
    """Validation/inference over every scenario of `dataset` with
    eval_step(batch) → (out, metrics). Scenarios a pack skips for capacity
    are counted and reported: the reference evaluates every scenario
    (test.py:82-90), so a nonzero drop count flags an undersized pack."""
    from lanegcn_tpu_torch.eval import (
        forecasting_metric_sums,
        metrics_from_sums,
        write_submission,
    )

    drop_stats: list = []
    # One pack worker: the stats (and the seq_ids in them) arrive in order.
    loader = _make_loader(dataset, config, bundle.name, shuffle=False,
                          drop_stats=drop_stats, to_device=True, device=device)
    preds, gts, probs = [], [], []
    t0 = time.time()
    for batch in loader.epoch(0):
        out, _ = eval_step(batch)
        p, g, pr = bundle.extract_fn(out, batch)
        preds.append(p)
        gts.append(g)
        probs.append(pr)
    k, t = config.model.num_mods, config.model.num_preds
    preds = np.concatenate(preds, 0) if preds else np.zeros((0, k, t, 2), np.float32)
    gts = np.concatenate(gts, 0) if gts else np.zeros((0, t, 2), np.float32)
    probs = np.concatenate(probs, 0) if probs else np.zeros((0, k), np.float32)
    seq_ids = np.concatenate(
        [np.asarray(s["seq_ids"], np.int64) for s in drop_stats]
    ) if drop_stats else np.zeros(0, np.int64)
    dropped = sum(s.get("skipped_scenarios", 0) for s in drop_stats)
    if submission:
        write_submission(submission, preds, seq_ids, probabilities=probs)
        print(f"wrote submission to {submission}")
    sums = forecasting_metric_sums(preds, gts)
    metrics = metrics_from_sums(sums)
    print(
        f"validation: {int(sums['count'])} scenarios in {time.time() - t0:.1f}s"
        + (f" (WARNING: {int(dropped)} dropped over pack capacity)" if dropped else "")
    )
    for k_, v in metrics.items():
        print(f"  {k_}: {v:.4f}")
    return metrics


def cmd_eval(args):
    from lanegcn_tpu_torch.device import resolve_device
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.train.checkpoint import load_checkpoint, load_pretrain
    from lanegcn_tpu_torch.train.loop import make_eval_step

    device = resolve_device(args.device)
    if args.torch_weight:
        # A reference-named state dict (e.g. the reference's published
        # 36.000.ckpt, reference README.MD:88, or a port checkpoint): the
        # port's module names are the reference's, so it loads as is.
        ck = torch.load(args.torch_weight, map_location="cpu")
    elif args.weight:
        ck = load_checkpoint(args.weight)
    else:
        ck = None
    # The compute dtype the run trained and validated in (a reference
    # checkpoint holds no `bf16`: fp32).
    bf16 = bool(ck is not None and ck.get("bf16", False))
    config = _default_config(args)
    bundle = get_model(args.model, config, dtype=torch.bfloat16 if bf16 else torch.float32,
                       device=device)
    config = bundle.config
    net = bundle.net
    if args.torch_weight:
        net.load_state_dict(ck["state_dict"], strict=True)
        print(f"imported torch checkpoint {args.torch_weight}")
    elif args.weight:
        load_pretrain(net, ck["state_dict"])
        print(f"loaded {args.weight}")
    eval_step = make_eval_step(config, net, device, bundle.loss_fn, bundle.metrics_fn)
    dataset = _parse_data(args.data, args.model)
    return _run_eval(config, bundle, dataset, eval_step, submission=args.submission,
                     device=device)


def cmd_preprocess(args):
    """Featurize + graph-build scenarios offline into pickle shards.

    Bakes the pack-ready blobs (precompute_pack_cache, and for LaneRCNN
    precompute_roi_cache) into each scenario so training-time packing is
    pure concatenation."""
    from lanegcn_tpu_torch.config import ModelConfig
    from lanegcn_tpu_torch.data.packing import precompute_pack_cache
    from lanegcn_tpu_torch.data.packing_roi import precompute_roi_cache

    dataset = _parse_data(args.data, args.model)
    model_cfg = ModelConfig()
    os.makedirs(args.out, exist_ok=True)
    shard, shard_id, per_shard = [], 0, args.shard_size
    t0 = time.time()
    for i in range(len(dataset)):
        scen = dataset[i]
        if "graph" in scen:
            precompute_pack_cache(scen, model_cfg)
        if "subgraphs" in scen:
            precompute_roi_cache(scen, model_cfg)
        shard.append(scen)
        if len(shard) == per_shard:
            path = os.path.join(args.out, f"shard_{shard_id:05d}.pkl")
            with open(path, "wb") as f:
                pickle.dump(shard, f, protocol=pickle.HIGHEST_PROTOCOL)
            shard, shard_id = [], shard_id + 1
            print(f"{i + 1}/{len(dataset)} scenarios ({time.time() - t0:.1f}s)")
    if shard:
        with open(os.path.join(args.out, f"shard_{shard_id:05d}.pkl"), "wb") as f:
            pickle.dump(shard, f, protocol=pickle.HIGHEST_PROTOCOL)
        shard_id += 1
    print(f"wrote {shard_id} shards to {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="lanegcn_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = "torch device (default cuda; cpu runs the kernels' plain versions)"

    pt = sub.add_parser("train")
    pt.add_argument("--model", default="lanegcn")
    pt.add_argument("--data", default="synthetic:256")
    pt.add_argument("--val-data", default=None)
    pt.add_argument("--epochs", type=int, default=2)
    pt.add_argument("--batch-size", type=int, default=8)
    pt.add_argument("--save-dir", default=None)
    pt.add_argument("--resume", default=None)
    pt.add_argument("--display-every", type=int, default=10)
    pt.add_argument("--rot-aug", action="store_true",
                    help="random rotation augmentation (reference rot_aug)")
    pt.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (fp32 params/normalization)")
    pt.add_argument("--seed", type=int, default=None,
                    help="training seed: weights, shuffle and augmentation")
    pt.add_argument("--save-freq", type=float, default=None,
                    help="checkpoint every N (fractional) epochs "
                         "(reference save_freq)")
    pt.add_argument("--val-every", type=float, default=0.0,
                    help="run validation every N (fractional) epochs "
                         "(reference val_iters)")
    pt.add_argument("--workers", type=int, default=1,
                    help="background packing threads (PackedLoader)")
    pt.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of steps 5-10 to DIR")
    pt.add_argument("--device", default=None, help=device_help)
    pt.set_defaults(fn=cmd_train)

    pe = sub.add_parser("eval")
    pe.add_argument("--model", default="lanegcn")
    pe.add_argument("--data", default="synthetic:64")
    pe.add_argument("--weight", default=None, help="a checkpoint of this package")
    pe.add_argument("--torch-weight", default=None,
                    help="a reference-named torch state_dict checkpoint "
                         "(e.g. the reference's 36.000.ckpt), loaded strictly")
    pe.add_argument("--batch-size", type=int, default=8)
    pe.add_argument("--submission", default=None,
                    help="write a competition submission file (h5/npz)")
    pe.add_argument("--device", default=None, help=device_help)
    pe.set_defaults(fn=cmd_eval)

    pp = sub.add_parser("preprocess")
    pp.add_argument("--model", default="lanegcn")
    pp.add_argument("--data", default="synthetic:512")
    pp.add_argument("--out", required=True)
    pp.add_argument("--shard-size", type=int, default=128)
    pp.set_defaults(fn=cmd_preprocess)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
