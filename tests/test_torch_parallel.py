"""Data parallelism of the port (``scda_tpu_torch/parallel/mesh.py``) on
the CPU with gloo: two ranks with batch 1 each against one process with
batch 2.

The JAX package's sharded step computes the loss of the global batch and
XLA sums the gradient; its one-process step is held against the port's
in ``test_torch_train.py`` and ``test_torch_scda.py``.  Here the port's
two ranks are held against the port's one process with the global batch:

  * two source-only steps and two SCDA joint steps on ``tiny`` (no
    dropout), the same weights and global batch: every metric and every
    parameter (detector and discriminator) after each run within 1e-5 of
    its norm (the ranks sum the gradient in another order than one
    batched backward; nothing else may differ), and the two replicas
    bit-equal;
  * the row shards of the random draws, and the sharded loader's rows,
    against the global draws and batches;
  * ``trainval --num_devices 2 --device cpu`` trains and checkpoints, and
    ``test_net --num_devices 2`` gives the detections of one process.

Each rank is a fresh interpreter (``torch.multiprocessing`` spawn) with
one CPU thread and a ``file://`` rendezvous in the test's temporary
directory, so parallel test workers never share a port.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from helpers import tiny_config
from scda_tpu_torch import bridge
from scda_tpu_torch.config import Config as PortConfig, _merge_into
from scda_tpu_torch.core.draws import RowShard, uniform
from scda_tpu_torch.data.pipeline import DataLoader
from scda_tpu_torch.parallel import mesh
from test_torch_train import train_batch, train_params
from torch_parallel_worker import STEPS, run_steps

TINY_SET = ["--set", "train.proposal.pre_nms_top_n=200",
            "train.proposal.post_nms_top_n=50",
            "train.rpn_target.batch_size=64", "train.roi_target.batch_size=32",
            "test.proposal.pre_nms_top_n=200",
            "test.proposal.post_nms_top_n=50", "anchors.scales=2,4,8"]


def port_config(jax_cfg):
    """The port's Config with the values of a JAX Config (the ranks
    unpickle it without the JAX package)."""
    return _merge_into(PortConfig(), dataclasses.asdict(jax_cfg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two schedules' runs: one process, then two spawned ranks."""
    tmp = tmp_path_factory.mktemp("parallel")
    cfg = port_config(tiny_config(adapt=True))
    cfg = _merge_into(cfg, {"adapt": {"d_channels": 16}})
    params = train_params("tiny", cfg, seed=3)
    sd = bridge.state_dict_from_jax(params, "tiny")
    image, info, gt, num = train_batch(4, cfg)
    tgt_image, tgt_info, _, _ = train_batch(5, cfg)
    batches = (image, info, gt, num, tgt_image, tgt_info)
    run_steps(None, torch.device("cpu"), cfg, sd, batches, str(tmp))
    rc = mesh.spawn(run_steps, 2, torch.device("cpu"), cfg, sd, batches,
                    str(tmp), threads=1, rendezvous_dir=str(tmp))
    assert rc == 0
    out = {name: torch.load(os.path.join(tmp, f"{name}.pt"))
           for name in ("single", "rank0", "rank1")}
    out["init"] = sd
    return out


@pytest.mark.parametrize("kind", ["source", "scda_joint"])
def test_two_ranks_metrics_equal_one_process(runs, kind):
    single, ranks = runs["single"][kind][0], runs["rank0"][kind][0]
    assert len(single) == len(ranks) == STEPS
    for step, (a, b) in enumerate(zip(single, ranks)):
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-5 * max(abs(a[k]), 1.0), (step, k)


@pytest.mark.parametrize("kind", ["source", "scda_joint"])
def test_two_ranks_params_equal_one_process(runs, kind):
    """Parameters after the steps, within 1e-5 of each tensor's norm
    (every trainable one moved: the comparison is not vacuous)."""
    single, ranks = runs["single"][kind][1], runs["rank0"][kind][1]
    assert set(single) == set(ranks)
    for name, p in single.items():
        gap = float((p - ranks[name]).norm())
        assert gap <= 1e-5 * max(float(p.norm()), 1e-6), (name, gap)
        if name in runs["init"]:
            moved = float((p - torch.from_numpy(runs["init"][name])).norm())
            assert moved > 100 * gap, (name, moved, gap)


@pytest.mark.parametrize("kind", ["source", "scda_joint"])
def test_replicas_stay_equal(runs, kind):
    a, b = runs["rank0"][kind], runs["rank1"][kind]
    assert a[0] == b[0]
    for name in a[1]:
        assert torch.equal(a[1][name], b[1][name]), name


def test_row_shards_are_rows_of_the_global_draw():
    """Each rank's draw is its rows of the one-process draw, for the
    shapes the step draws at: (B, 2, K) targets, (B*S, D) dropout."""
    for shape in ((4, 2, 37), (12, 8)):
        whole = uniform(torch.Generator().manual_seed(5), shape)
        parts = [uniform(RowShard(torch.Generator().manual_seed(5), r, 2),
                         (shape[0] // 2, *shape[1:])) for r in range(2)]
        assert torch.equal(torch.cat(parts), whole)


def test_sharded_loader_rows(tmp_path):
    """Two ranks' batches concatenated are the one-process loader's, over
    two epochs (shuffle and flips), and ``len`` is the global one."""
    from scda_tpu_torch.data.synthetic import make_synthetic_dataset

    cfg = port_config(tiny_config())
    ds = make_synthetic_dataset(str(tmp_path / "ds"), num_images=6,
                                image_size=(128, 192), seed=0, split="train")
    whole = DataLoader(ds, cfg.data, 2, seed=3, augment_flip=True)
    shards = [mesh.ShardedDataLoader(ds, cfg.data, 2, seed=3,
                                     augment_flip=True,
                                     world=mesh.World(r, 2))
              for r in range(2)]
    assert len(shards[0]) == len(whole)
    for _ in range(2):
        for ref, *parts in zip(whole, *shards):
            np.testing.assert_array_equal(
                np.concatenate([p.image for p in parts]), ref.image)
            np.testing.assert_array_equal(
                np.concatenate([p.indices for p in parts]), ref.indices)
    with pytest.raises(ValueError, match="divide"):
        mesh.ShardedDataLoader(ds, cfg.data, 3, world=mesh.World(0, 2))


def test_world_size_from_num_devices():
    assert mesh.num_devices(0, torch.device("cpu")) == 1
    assert mesh.num_devices(3, torch.device("cpu")) == 3
    assert mesh.rank_device(torch.device("cuda"), 1) == torch.device("cuda", 1)
    assert mesh.rank_device(torch.device("cpu"), 1) == torch.device("cpu")


def test_cli_trains_and_evaluates_on_two_ranks(tmp_path, monkeypatch):
    """``trainval --num_devices 2 --device cpu`` trains two steps at the
    global batch 2 and checkpoints once (rank 0); ``test_net
    --num_devices 2`` on that checkpoint writes the detections one
    process writes."""
    from scda_tpu_torch.cli import test_net, trainval
    from scda_tpu_torch.train import checkpoint as ckpt

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    save = str(tmp_path / "models")
    common = ["--net", "tiny", "--device", "cpu", "--synth_images", "4",
              "--synth_size", "128", "192"]
    assert trainval.main(common + [
        "--dataset", "synthetic", "--steps", "2", "--bs", "2",
        "--num_devices", "2", "--save_dir", save] + TINY_SET) == 0
    run_dir = os.path.join(save, "tiny", "synthetic")
    assert ckpt.latest_step(run_dir) == 2
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line)["train"] for line in f]
    assert [m["step"] for m in logged] == [1] and logged[0]["fg_cnt"] >= 1
    dets = {}
    for n in ("1", "2"):
        dets[n] = str(tmp_path / f"dets{n}.json")
        assert test_net.main(common + [
            "--load_dir", save, "--bs", "2", "--num_devices", n,
            "--dets_out", dets[n]] + TINY_SET) == 0
    with open(dets["1"]) as f1, open(dets["2"]) as f2:
        one, two = json.load(f1), json.load(f2)
    assert one == two and sum(map(len, one.values())) > 0
