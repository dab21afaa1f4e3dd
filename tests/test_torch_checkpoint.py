"""The port's checkpoint (lanegcn_tpu_torch/train/checkpoint.py) on a narrow
LaneGCN (32 channels, 2 LaneConv layers a stack) on the CPU: the round trip
bitwise and readable with weights_only=True, no .tmp left behind,
load_pretrain's shape-checked partial restore, the parameters still views
of the optimizer's flat buffer after a load, and a resumed run bitwise
equal to the run that never stopped, with Adam and with SGD (whose trace
the checkpoint carries instead of the moments). Also the metric
accumulator's device sums against Python floats, and the profiler hook."""

import dataclasses

import os

import pytest
import torch

from lanegcn_tpu_torch.config import Config, ModelConfig, TrainConfig, contiguous_pack_config
from lanegcn_tpu_torch.data.packing import pack_batch
from lanegcn_tpu_torch.data.synthetic import make_synthetic_scenario
from lanegcn_tpu_torch.models.lanegcn import LaneGCN
from lanegcn_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_pretrain,
    restore_train_state,
    save_checkpoint,
)
from lanegcn_tpu_torch.train.loop import MetricAccumulator, init_state, make_train_step
from lanegcn_tpu_torch.utils.profiling import trace_context

CFG = Config(model=ModelConfig(n_actor=32, n_map=32, num_fuse_layers=2, num_att_layers=2),
             pack=contiguous_pack_config(2))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's train steps: they are many small
    ops, and beside other test processes each op's thread barrier would
    wait on cores those processes hold (100x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def packs():
    scens = [make_synthetic_scenario(seed=i, num_corridors=1, num_actors=4) for i in range(6)]
    return [pack_batch(scens[i:i + 2], CFG.pack, CFG.model)[0] for i in (0, 2, 4)]


def _fresh(seed=0, cfg=CFG):
    return init_state(cfg, net=LaneGCN(cfg.model, device="cpu", seed=seed), device="cpu")


def _train(net, state, packs, start, steps, spe=3, cfg=CFG):
    step = make_train_step(cfg, net, state, device="cpu")
    for i in range(start, start + steps):
        step(packs[i % len(packs)], i / spe)


def _assert_payloads_equal(a, b):
    assert a["step"] == b["step"] and a["epoch"] == b["epoch"]
    assert a["state_dict"].keys() == b["state_dict"].keys()
    for k in a["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k
    for k in ("flat", "mu", "nu", "count"):
        assert torch.equal(a["flat_adam"][k], b["flat_adam"][k]), k


def _views_of_flat(net, state):
    flat = state.opt.flat
    base = flat.untyped_storage().data_ptr()
    return all(p.untyped_storage().data_ptr() == base for p in net.parameters())


def test_round_trip_is_bitwise_and_weights_only(tmp_path, packs):
    net, state = _fresh()
    _train(net, state, packs, 0, 1)
    path = str(tmp_path / "0.333.ckpt")
    save_checkpoint(path, net, state, 1 / 3)
    assert os.listdir(tmp_path) == ["0.333.ckpt"]  # no .tmp left behind
    ck = torch.load(path, map_location="cpu", weights_only=True)
    assert ck["step"] == 1 and ck["epoch"] == 1 / 3 and ck["bf16"] is False
    assert ck["flat_adam"]["count"].dtype == torch.int32 and int(ck["flat_adam"]["count"]) == 1
    for k, v in net.state_dict().items():
        assert torch.equal(ck["state_dict"][k], v), k
        # Compact copies, not views of the flat buffer.
        assert ck["state_dict"][k].untyped_storage().nbytes() == v.numel() * v.element_size()
    for k in ("flat", "mu", "nu", "count"):
        assert torch.equal(ck["flat_adam"][k], getattr(state.opt, k)), k

    net2, state2 = _fresh(seed=9)
    assert load_pretrain(net2, ck["state_dict"]) == []
    restore_train_state(state2, ck)
    assert _views_of_flat(net2, state2)
    for (k, a), b in zip(net.state_dict().items(), net2.parameters()):
        assert torch.equal(a, b), k
    save_checkpoint(str(tmp_path / "again.ckpt"), net2, state2, ck["epoch"], bf16=True)
    again = load_checkpoint(str(tmp_path / "again.ckpt"))
    _assert_payloads_equal(ck, again)
    assert again["bf16"] is True  # the compute dtype an eval of it runs in


def test_load_pretrain_skips_wrong_shapes_and_unknown_keys():
    net, state = _fresh(seed=1)
    donor = LaneGCN(CFG.model, device="cpu", seed=2).state_dict()
    keys = list(donor)
    wrong = keys[3]
    donor[wrong] = torch.zeros(donor[wrong].numel() + 1)
    donor["not_a_module.weight"] = torch.ones(4)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    skipped = load_pretrain(net, donor)
    assert skipped == sorted([wrong, "not_a_module.weight"])
    after = net.state_dict()
    assert torch.equal(after[wrong], before[wrong])
    for k in keys:
        if k != wrong:
            assert torch.equal(after[k], donor[k]), k
    # In place: the parameters are still the optimizer's flat buffer.
    assert _views_of_flat(net, state)
    assert torch.equal(torch.cat([p.reshape(-1) for p in net.parameters()]), state.opt.flat)


def test_resumed_run_is_bitwise_the_straight_run(tmp_path, packs):
    net, state = _fresh()
    _train(net, state, packs, 0, 3)
    save_checkpoint(str(tmp_path / "straight.ckpt"), net, state, 1.0)

    net, state = _fresh()
    _train(net, state, packs, 0, 1)
    save_checkpoint(str(tmp_path / "cut.ckpt"), net, state, 1 / 3)
    del net, state
    net, state = _fresh(seed=4)  # fresh net and optimizer, other weights
    ck = load_checkpoint(str(tmp_path / "cut.ckpt"))
    load_pretrain(net, ck["state_dict"])
    restore_train_state(state, ck)
    _train(net, state, packs, state.step, 2)
    save_checkpoint(str(tmp_path / "resumed.ckpt"), net, state, 1.0)
    _assert_payloads_equal(load_checkpoint(str(tmp_path / "straight.ckpt")),
                           load_checkpoint(str(tmp_path / "resumed.ckpt")))


def test_sgd_trace_round_trips_and_resumes_bitwise(tmp_path, packs):
    """opt="sgd": the checkpoint holds `flat_sgd` (flat and the momentum
    trace, no moments), restores into a fresh optimizer, refuses an Adam
    one, and a run resumed from it ends bitwise the straight run."""
    cfg = dataclasses.replace(CFG, train=TrainConfig(opt="sgd", lr=(0.05,), lr_epochs=()))
    net, state = _fresh(cfg=cfg)
    _train(net, state, packs, 0, 3, cfg=cfg)
    straight = str(tmp_path / "straight.ckpt")
    save_checkpoint(straight, net, state, 1.0)

    net, state = _fresh(cfg=cfg)
    _train(net, state, packs, 0, 1, cfg=cfg)
    save_checkpoint(str(tmp_path / "cut.ckpt"), net, state, 1 / 3)
    ck = load_checkpoint(str(tmp_path / "cut.ckpt"))
    assert "flat_adam" not in ck and set(ck["flat_sgd"]) == {"flat", "trace"}
    assert torch.equal(ck["flat_sgd"]["trace"], state.opt.trace)
    assert float(ck["flat_sgd"]["trace"].abs().sum()) > 0
    with pytest.raises(ValueError, match="flat_adam"):
        restore_train_state(_fresh()[1], ck)
    net, state = _fresh(seed=4, cfg=cfg)
    load_pretrain(net, ck["state_dict"])
    restore_train_state(state, ck)
    assert _views_of_flat(net, state) and torch.equal(state.opt.trace, ck["flat_sgd"]["trace"])
    _train(net, state, packs, state.step, 2, cfg=cfg)
    save_checkpoint(str(tmp_path / "resumed.ckpt"), net, state, 1.0)
    a, b = load_checkpoint(straight), load_checkpoint(str(tmp_path / "resumed.ckpt"))
    assert a["step"] == b["step"] == 3
    for k in a["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k
    for k in ("flat", "trace"):
        assert torch.equal(a["flat_sgd"][k], b["flat_sgd"][k]), k


def test_metric_accumulator_sums_on_device_as_python_floats():
    """The fp64 device sums convert to bitwise the Python-float sums of the
    old accumulator, on the same metric sequence."""
    gen = torch.Generator().manual_seed(0)
    seq = [{"loss": torch.rand((), generator=gen), "lr": torch.tensor(1e-3),
            "cls_loss": torch.rand((), generator=gen) * 50, "num_cls": torch.tensor(7.0),
            "reg_loss": torch.rand((), generator=gen) * 1e3, "num_reg": torch.tensor(389.0),
            "num_scen": torch.tensor(2.0), "ade1_sum": torch.rand((), generator=gen) * 30,
            "fde1_sum": torch.rand((), generator=gen) * 60, "ade_sum": -torch.zeros(()),
            "fde_sum": torch.rand((), generator=gen), "mr_sum": torch.tensor(1.0),
            "skipped": 0.0} for _ in range(13)]
    acc = MetricAccumulator()
    old = {}
    for m in seq:
        acc.update(m)
        for k, v in m.items():
            if k not in ("loss", "lr"):
                old[k] = old.get(k, 0.0) + float(v)
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float64
               for k, v in acc.sums.items() if k != "skipped")
    assert acc.host_sums() == old
    s = acc.summary()
    assert s["reg"] == old["reg_loss"] / (old["num_reg"] + 1e-10)
    assert s["ade1"] == old["ade1_sum"] / (old["num_scen"] + 1e-10)
    acc.reset()
    assert acc.summary()["loss"] == 0.0


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with trace_context(str(tmp_path / "prof")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    with trace_context(None):
        pass
