"""The port's CLI (python -m lanegcn_tpu_torch.cli) end to end on the CPU at
full width, on tiny scenarios: preprocess to shards, train from them with
validation and a checkpoint, eval by --weight and by --torch-weight
printing the validation's metrics, a preempted run resumed bitwise to the
uninterrupted run's checkpoint (the JAX CLI replays the epoch's first
groups on resume; the port skips them), LaneRCNN for one pack, and no
quiet fallback to the CPU."""

import os

import pytest
import torch

from lanegcn_tpu_torch import cli
from lanegcn_tpu_torch.train.checkpoint import load_checkpoint
from lanegcn_tpu_torch.train.preempt import PreemptionGuard

VAL = "synthetic:2:1:4"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's train steps: they are many small
    ops, and beside other test processes each op's thread barrier would
    wait on cores those processes hold (100x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_args(data, save_dir, *extra):
    return ["train", "--device", "cpu", "--data", data, "--epochs", "1", "--batch-size", "1",
            "--workers", "2", "--save-freq", "1", "--display-every", "1",
            "--save-dir", save_dir, *extra]


def _metric_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith(("  minADE", "  minFDE", "  MR_"))]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """preprocess 3 scenarios into 2 shards, then one epoch of 3 packs of
    one scenario from them with validation."""
    root = tmp_path_factory.mktemp("cli")
    shards, r1 = str(root / "shards"), str(root / "r1")
    cli.main(["preprocess", "--data", "synthetic:3:1:4", "--out", shards, "--shard-size", "2"])
    cli.main(_train_args(shards, r1, "--val-data", VAL))
    return dict(root=root, shards=shards, r1=r1, log=open(os.path.join(r1, "log")).read())


def test_train_from_shards_validates_and_checkpoints(run):
    assert sorted(os.listdir(run["shards"])) == ["shard_00000.pkl", "shard_00001.pkl"]
    assert sorted(f for f in os.listdir(run["r1"]) if f.endswith(".ckpt")) == ["1.000.ckpt"]
    log = run["log"]
    assert "3 steps/epoch on cpu" in log
    lines = [ln for ln in log.splitlines() if ln.startswith("epoch ")]
    assert len(lines) == 3 and "dropped" not in log
    assert f"saved {os.path.join(run['r1'], '1.000.ckpt')}" in log
    assert "validation: 2 scenarios in" in log and len(_metric_lines(log)) == 6
    assert os.path.isfile(os.path.join(run["r1"], "files", "lanegcn_tpu_torch", "cli.py"))
    assert os.path.isfile(os.path.join(run["r1"], "files", "run.json"))


def test_eval_prints_the_validation_metrics(run, capsys):
    ckpt = os.path.join(run["r1"], "1.000.ckpt")
    cli.main(["eval", "--device", "cpu", "--data", VAL, "--batch-size", "1", "--weight", ckpt,
              "--submission", str(run["root"] / "sub.npz")])
    by_weight = capsys.readouterr().out
    assert _metric_lines(by_weight) == _metric_lines(run["log"])
    # A reference-named state dict (no `bf16`: fp32, as this run) loads
    # strictly and gives the same lines.
    ref = str(run["root"] / "reference.ckpt")
    torch.save({"state_dict": load_checkpoint(ckpt)["state_dict"]}, ref)
    cli.main(["eval", "--device", "cpu", "--data", VAL, "--batch-size", "1",
              "--torch-weight", ref])
    assert _metric_lines(capsys.readouterr().out) == _metric_lines(run["log"])


class _StopAfterTwoSteps(PreemptionGuard):
    """A guard that reads as triggered from the 2nd step on (the loop asks
    once a step), as if SIGTERM had come during step 2."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.asked = 0

    @property
    def triggered(self):
        self.asked += 1
        return self.asked >= 2

    @property
    def signal_name(self):
        return "SIGTERM"


def test_preempted_run_resumes_bitwise(run, monkeypatch, capsys):
    r2 = str(run["root"] / "r2")
    with monkeypatch.context() as m:
        m.setattr(cli, "PreemptionGuard", _StopAfterTwoSteps)
        cli.main(_train_args(run["shards"], r2))
    cut = os.path.join(r2, "0.667.ckpt")
    assert f"SIGTERM: saved {cut}, exiting" in capsys.readouterr().out
    assert load_checkpoint(cut)["step"] == 2
    cli.main(_train_args(run["shards"], r2, "--resume", cut))
    out = capsys.readouterr().out
    assert f"resumed from {cut} at epoch 0.667" in out
    # One step left in the epoch: the two trained ones are skipped.
    assert [ln.split(" lr")[0] for ln in out.splitlines() if ln.startswith("epoch ")] == \
        ["epoch 0.667"]
    a = load_checkpoint(os.path.join(run["r1"], "1.000.ckpt"))
    b = load_checkpoint(os.path.join(r2, "1.000.ckpt"))
    assert a["step"] == b["step"] == 3 and a["epoch"] == b["epoch"] == 1.0
    for k in a["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k
    for k in ("flat", "mu", "nu", "count"):
        assert torch.equal(a["flat_adam"][k], b["flat_adam"][k]), k


def test_lanercnn_trains_one_pack(tmp_path, capsys):
    cli.main(["train", "--device", "cpu", "--model", "lanercnn", "--data", "synthetic:1:1:4",
              "--epochs", "1", "--batch-size", "1", "--display-every", "1"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("epoch ")]
    assert "model lanercnn:" in out and "1 steps/epoch on cpu" in out
    assert len(lines) == 1 and "dropped" not in out
    loss = float(lines[0].split("loss ")[1].split()[0])
    assert loss == loss and abs(loss) < float("inf")


def test_train_without_cuda_or_device_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--data", "synthetic:2:1:4", "--save-dir", str(tmp_path / "r")])
    assert not os.path.exists(tmp_path / "r")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["eval", "--data", "synthetic:2:1:4"])
