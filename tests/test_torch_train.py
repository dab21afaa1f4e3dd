"""The port's training path against the JAX package's, on the small world of
tests/test_torch_model.py (32 channels, 2 LaneConv layers per stack, 2 Att
per fusion stage, one windowed 3-scenario pack with the grouped window plan
and all three fusion pair plans), with one JAX init carried across by the
weight bridge. Everything runs in float32 on the CPU.

- (a) the gradient of pred_loss, leaf by leaf, against jax.grad;
- (b) the flat Adam (clip, weight decay, lr_coef, StepLR across a boundary)
  against JAX's fused_apply on the same gradients;
- (c) the NaN guard; (d) step_lr at fractional epochs; (e) the loss falls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from lanegcn_tpu.config import PackConfig as JPackConfig, TrainConfig as JTrainConfig
from lanegcn_tpu.data.packing import pack_batch as jax_pack_batch
from lanegcn_tpu.data.synthetic import make_urban_scenario as jax_make_urban
from lanegcn_tpu.models.lanegcn import LaneGCN as JLaneGCN, pred_loss as jax_pred_loss
from lanegcn_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from lanegcn_tpu.train.optimizer import step_lr as jax_step_lr

from lanegcn_tpu_torch.config import Config, ModelConfig, PackConfig, TrainConfig
from lanegcn_tpu_torch.graph import PackedBatch
from lanegcn_tpu_torch.models.lanegcn import LaneGCN
from lanegcn_tpu_torch.train.loop import init_state, make_train_step, train_epochs
from lanegcn_tpu_torch.train.optimizer import make_optimizer, step_lr
from lanegcn_tpu_torch.utils.weights import export_state_dict, load_jax_params

MODEL = dict(n_actor=32, n_map=32, num_fuse_layers=2, num_att_layers=2)
PACK = dict(
    max_scenarios=3, max_actors=96, max_nodes=512 * 4, node_stride=512,
    max_plan_edges=1024, table_relations=(), actor_stride=32, fusion_pairs=True,
    pair_chunk=128, max_edges_scale0=512, max_edges_dilated=512, max_edges_lr=512,
    max_a2m_edges=6144, max_m2a_edges=6144, max_a2a_edges=1536)


def _pack(seed0):
    jcfg = JConfig(model=JModelConfig(**MODEL), pack=JPackConfig(**PACK))
    scens = [jax_make_urban(seed=seed0 + i, num_corridors=3, num_actors=8) for i in range(3)]
    batch, stats = jax_pack_batch(scens, jcfg.pack, jcfg.model)
    assert stats["packed_scenarios"] == 3
    assert not any(v for k, v in stats.items() if k.startswith("dropped")), stats
    return batch


@pytest.fixture(scope="module")
def world():
    jcfg = JConfig(model=JModelConfig(**MODEL), pack=JPackConfig(**PACK))
    batches = [_pack(50), _pack(60)]
    jb = jax.tree.map(jnp.asarray, batches[0])
    jnet = JLaneGCN(jcfg.model)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jb)["params"]
    return dict(jcfg=jcfg, jnet=jnet, params=params, params_np=jax.tree.map(np.asarray, params),
                batches=batches, jb=jb)


def _port_net(world, train=TrainConfig()):
    cfg = Config(model=ModelConfig(**MODEL), pack=PackConfig(**PACK), train=train)
    net = LaneGCN(cfg.model, device="cpu")
    load_jax_params(net, world["params_np"], cfg.model)
    return cfg, net


def test_grads_match_jax_grad(world):
    """(a) Every parameter's gradient of pred_loss against jax.grad of the
    JAX objective, per leaf: within 1e-4 · max |reference leaf|. Both sides
    run the same float32 model; they sum in different orders through ~20
    GroupNorm'd layers and the gradient of a normalized sum, so leaves agree
    to ~1e-6 of their largest element (a 100x margin)."""
    jcfg, jnet = world["jcfg"], world["jnet"]

    def objective(p):
        return jax_pred_loss(jnet.apply({"params": p}, world["jb"]), world["jb"], jcfg.loss)["loss"]

    jloss, jgrads = jax.jit(jax.value_and_grad(objective))(world["params"])
    ref = export_state_dict(jax.tree.map(np.asarray, jgrads), jcfg.model)

    cfg, net = _port_net(world)
    net, state = init_state(cfg, net=net, device="cpu")
    metrics = make_train_step(cfg, net, state, device="cpu")(world["batches"][0], 0.0)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
    got = {name: p.grad for name, p in net.named_parameters()}
    assert set(got) == set(ref)
    for name, g in got.items():
        assert g is not None, f"{name}: no gradient"
        want = ref[name]
        tol = 1e-4 * float(np.abs(want).max()) + 1e-9
        err = float(np.abs(g.numpy() - want).max())
        assert err <= tol, f"{name}: max abs err {err} > {tol}"
    assert float(metrics["skipped"]) == 0.0


def test_fused_adam_matches_jax_fused_apply(world):
    """(b) Three updates on the same numpy gradients, with elementwise clip,
    weight decay and lr_coef rules, across an lr boundary (epochs 0, 0.01,
    0.03 with the boundary at 0.02): params within 1e-6 of JAX's (both
    compute the same fp32 elementwise formula)."""
    rules = (("map_net/fuse", 0.5), ("a2m/att1", 2.0), ("pred_net", 0.25))
    kw = dict(lr=(1e-3, 1e-4), lr_epochs=(0.02,), weight_decay=1e-2, clip_grads=True,
              clip_low=-0.5, clip_high=0.5, lr_coef=rules)
    jtx, jlr = jax_make_optimizer(JTrainConfig(**kw))
    cfg, net = _port_net(world, TrainConfig(**kw))
    opt, lr_fn = make_optimizer(cfg.train, net)
    params = world["params"]
    jstate = jtx.init(params)
    rng = np.random.RandomState(3)
    for epoch in (0.0, 0.01, 0.03):
        grads_np = jax.tree.map(lambda p: (rng.randn(*p.shape) * 0.4).astype(np.float32),
                                world["params_np"])
        params, jstate = jtx.fused_apply(params, jax.tree.map(jnp.asarray, grads_np), jstate,
                                         jlr(epoch))
        for name, g in export_state_dict(grads_np, cfg.model).items():
            dict(net.named_parameters())[name].grad = torch.from_numpy(g)
        opt.step(lr_fn(epoch))
    assert int(opt.count) == 3
    ref = export_state_dict(jax.tree.map(np.asarray, params), cfg.model)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0, atol=1e-6,
                                   err_msg=name)
    # Every rule matched some parameter (the coefficients in use are the
    # rules' and the default 1.0).
    assert opt.coef is not None and set(opt.coef.unique().tolist()) == {0.25, 0.5, 1.0, 2.0}


def test_nan_guard_skips_a_poisoned_batch(world):
    """(c) A non-finite loss leaves params, moments and count bitwise
    unchanged and reports skipped = 1 (JAX: tests/test_training.py:113)."""
    cfg, net = _port_net(world)
    net, state = init_state(cfg, net=net, device="cpu")
    step = make_train_step(cfg, net, state, device="cpu")
    m = step(world["batches"][0], 0.0)
    assert float(m["skipped"]) == 0.0
    opt = state.opt
    before = [t.clone() for t in (opt.flat, opt.mu, opt.nu, opt.count)]
    poisoned = PackedBatch.from_numpy(world["batches"][1])
    poisoned.actors.feats[0, 0, 0] = float("nan")
    m = step(poisoned, 0.01)
    assert not np.isfinite(float(m["loss"]))
    assert float(m["skipped"]) == 1.0
    for a, b in zip(before, (opt.flat, opt.mu, opt.nu, opt.count)):
        assert torch.equal(a, b)
    # A finite step after it updates again.
    m = step(world["batches"][1], 0.02)
    assert float(m["skipped"]) == 0.0 and int(opt.count) == 2


def test_step_lr_matches_jax_at_fractional_epochs():
    """(d) The schedule, piecewise constant on the fractional epoch."""
    lrs, bounds = (1e-3, 1e-4, 1e-5), (32.0, 35.0)
    jfn, fn = jax_step_lr(lrs, bounds), step_lr(lrs, bounds)
    for e in (0.0, 0.5, 31.999, 32.0, 32.25, 34.9999, 35.0, 40.0):
        got = fn(e, "cpu")
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == float(jfn(e)), e
    assert float(fn(torch.tensor(33.5))) == float(jfn(33.5))


def test_loss_falls_over_ten_steps(world):
    """(e) Ten Adam steps alternating the two packs (lr 3e-3) bring the mean
    loss of the last two steps below 0.8 of the first two."""
    cfg, net = _port_net(world, TrainConfig(lr=(3e-3,), lr_epochs=()))
    net, state = init_state(cfg, net=net, device="cpu")
    step = make_train_step(cfg, net, state, device="cpu")
    batches = [PackedBatch.from_numpy(b) for b in world["batches"]]
    losses = [float(step(batches[i % 2], i / 100.0)["loss"]) for i in range(10)]
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-2:]) < 0.8 * np.mean(losses[:2]), losses


def test_train_epochs_runs_its_steps(world):
    """train_epochs stops at num_steps, feeds each step the fractional epoch
    step / steps_per_epoch, logs every log_every steps and returns finite
    averages."""
    cfg, net = _port_net(world, TrainConfig(lr=(1e-3, 1e-4), lr_epochs=(0.2,)))
    net, state = init_state(cfg, net=net, device="cpu")
    logs = []
    batches = [PackedBatch.from_numpy(b) for b in world["batches"]] * 3
    state, summary = train_epochs(cfg, net, state, batches, num_steps=4, steps_per_epoch=10,
                                  log_every=2, log_fn=logs.append, device="cpu")
    assert state.step == 4 and int(state.opt.count) == 4
    assert len(logs) == 2 and logs[0].startswith("step 2 epoch 0.100 lr 0.00100")
    assert logs[1].startswith("step 4 epoch 0.300 lr 0.00010")
    assert all(np.isfinite(v) for v in summary.values()), summary


def test_sgd_is_not_ported_yet():
    cfg = Config(model=ModelConfig(**MODEL), train=TrainConfig(opt="sgd"))
    with pytest.raises(NotImplementedError, match="sgd"):
        init_state(cfg, device="cpu")
