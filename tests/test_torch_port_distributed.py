"""The port's multi-process training on the CPU (``parallel/distributed.py``,
the step's global-batch losses and summed gradients, the trainer).

* Two gloo processes, each on its half of a global batch of 8 (patch 8^3,
  features [8, 16], BCEDice + a normals head with MaskedCosine whose masks
  differ between the halves), take one AdamW step; the JAX package's
  single-process ``make_train_step`` takes it on the whole batch from the
  same parameters (``params_from_jax``). Loss and grad_norm within
  STEP_TOL relative, every parameter within STEP_TOL in relative L2, both
  ranks' parameters bit-equal. The batch discriminates: the mean of the
  ranks' own losses differs from the global loss by more than STEP_TOL, so
  a port that averaged per-rank losses fails.
* The per-sample draws (dropout, DropPath, the device augmentation) of two
  processes are those of one: two accumulated steps, 2 ranks against 1,
  within STEP_TOL.
* The trainer: 2 processes for 2 epochs of SGD against 1 process, the
  epochs' train losses within STEP_TOL, the parameters within
  TRAINER_PARAM_TOL; only rank 0 writes (metrics, checkpoints, the final
  weights). SGD, because Adam's first updates are ``lr * g / |g|``: an
  fp32 rounding of a near-zero gradient element flips a whole step.
* A process group of one (the card's NCCL world of 1 in chip_smoke.py
  phase 14a) runs the collectives and gives the undistributed step bit for
  bit; ``initialize`` reads JAX's and torchrun's environment names.

Each worker process has a timeout of ``torch_port_dist_worker.TIMEOUT_S``.
"""

import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist_worker as worker
from mt3d_resenc_unet_tpu.core.plan import TaskHead as JTaskHead
from mt3d_resenc_unet_tpu.core.plan import plan_from_manual_config as jplan
from mt3d_resenc_unet_tpu.models.network import ResEncUNet as JaxUNet
from mt3d_resenc_unet_tpu.train import losses as jl
from mt3d_resenc_unet_tpu.train import step as js
from mt3d_resenc_unet_torch.parallel import distributed as dist
from mt3d_resenc_unet_torch.parallel.mesh import pad_batch_to_devices
from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax
from mt3d_resenc_unet_torch.tools.synthetic_data import write_sheet_dataset

STEP_TOL = 1e-5
# the trainer's parameters after 4 SGD steps, 2 ranks against 1, relative
# L2: each rank's conv backward sums a batch of 2 where one process sums 4,
# and fp32 rounding moves a LeakyReLU input across 0 here and there (a
# kink that moves a weight gradient by up to ~1%); measured 2.7e-5
TRAINER_PARAM_TOL = 1e-4
PATCH = (8, 8, 8)
MODEL = dict(basic_encoder_block="BasicBlockD", basic_decoder_block="ConvBlock",
             bottleneck_block="BasicBlockD", features_per_stage=[8, 16],
             num_stages=2, n_blocks_per_stage=[1, 1],
             n_conv_per_stage_decoder=[1], kernel_sizes=3, strides=[1, 2])
TASKS = [("sheet", 1, "sigmoid"), ("normals", 3, "none")]
LOSS_CFG = {"sheet": {"loss_fn": "BCEDiceLoss"},
            "normals": {"loss_fn": "MaskedCosineLoss"}}


def _global_batch(n=8, seed=42):
    """Labels dense in the first half, sparse in the second; normals set
    on every voxel of the first half and on ~10% of the second's."""
    rng = np.random.default_rng(seed)
    shape = (n,) + PATCH
    density = np.where(np.arange(n) < n // 2, 0.6, 0.05)
    keep = np.where(np.arange(n) < n // 2, 1.0, 0.1)
    normals = rng.standard_normal(shape + (3,)).astype(np.float32)
    normals *= (rng.random(shape + (1,)) < keep[:, None, None, None, None])
    return {"image": rng.random(shape + (1,), np.float32),
            "sheet": (rng.random(shape + (1,))
                      < density[:, None, None, None, None]).astype(
                          np.float32),
            "normals": normals}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_step")
    plan = jplan(MODEL, PATCH, 1, [JTaskHead(*t) for t in TASKS])
    model = JaxUNet(plan=plan, dtype=jnp.float32)
    params = jax.jit(lambda: model.init(
        {"params": jax.random.key(0)}, jnp.zeros((1,) + PATCH + (1,)),
        train=False))()["params"]
    tx = js.build_optimizer("AdamW", js.cosine_epoch_schedule(1e-3, 10, 5))
    state = js.TrainState.create(apply_fn=model.apply, params=params, tx=tx,
                                 rng=jax.random.key(1))
    step = js.make_train_step(model, jl.build_task_losses(LOSS_CFG),
                              {k: 1.0 for k in LOSS_CFG}, donate=False)
    batch = _global_batch()
    state, metrics = step(state, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    ref = {"loss": float(metrics["total_loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "params": params_from_jax(jax.tree.map(np.asarray,
                                                  state.params))}
    inputs = {"model_config": MODEL, "patch": PATCH, "tasks": TASKS,
              "loss_cfg": LOSS_CFG, "batch": batch,
              "params": params_from_jax(jax.tree.map(np.asarray, params))}
    return ref, worker.launch("step", 2, inputs, tmp, "step")


def test_two_process_step_loss_and_grad_norm_match_jax(step_runs):
    ref, multi = step_runs
    for r in multi:
        m = r["history"][0]
        np.testing.assert_allclose(m["total_loss"], ref["loss"],
                                   rtol=STEP_TOL)
        np.testing.assert_allclose(m["grad_norm"], ref["grad_norm"],
                                   rtol=STEP_TOL)


def test_two_process_step_parameters_match_jax(step_runs):
    ref, multi = step_runs
    got = multi[0]["params"]
    assert set(got) == set(ref["params"])
    for name, want in ref["params"].items():
        assert _rel_l2(got[name], want) <= STEP_TOL, name


def test_two_process_ranks_hold_bit_equal_parameters(step_runs):
    _, (r0, r1) = step_runs
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["is_main"] and not r1["is_main"]
    for name, value in r0["params"].items():
        assert torch.equal(value, r1["params"][name]), name
    assert r0["history"] == r1["history"]


def test_the_batch_tells_global_loss_from_averaged_rank_losses(step_runs):
    """A port that took each rank's loss on its own samples and averaged
    the ranks would miss the global loss by more than STEP_TOL here."""
    ref, multi = step_runs
    averaged = np.mean([r["local_loss"] for r in multi])
    assert abs(averaged - ref["loss"]) > 100 * STEP_TOL * abs(ref["loss"])


def test_two_process_draws_match_one_process(tmp_path):
    """Dropout, DropPath and the device augmentation draw for the global
    batch: two ranks equal one over two steps of two microbatches."""
    from mt3d_resenc_unet_torch.core.plan import (TaskHead,
                                                  plan_from_manual_config)
    from mt3d_resenc_unet_torch.models.network import ResEncUNet
    cfg = dict(MODEL, dropout_op_kwargs={"p": 0.2}, stochastic_depth_p=0.3)
    plan = plan_from_manual_config(cfg, PATCH, 1,
                                   [TaskHead(*t) for t in TASKS])
    params = ResEncUNet(plan, seed=3).state_dict()
    inputs = {"model_config": cfg, "patch": PATCH, "tasks": TASKS,
              "loss_cfg": LOSS_CFG, "batch": _global_batch(),
              "params": params, "augment": True, "accum": 2, "steps": 2}
    one = worker.launch("step", 1, inputs, tmp_path, "one")[0]
    two = worker.launch("step", 2, inputs, tmp_path, "two")
    for got in two:
        for step_got, step_want in zip(got["history"], one["history"]):
            for key, want in step_want.items():
                np.testing.assert_allclose(step_got[key], want,
                                           rtol=STEP_TOL, err_msg=key)
        for name, want in one["params"].items():
            assert _rel_l2(got["params"][name], want) <= STEP_TOL, name


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    return write_sheet_dataset(tmp_path_factory.mktemp("dist_vols"),
                               (32, 40, 40), seed=3, chunks=(16, 16, 16))


def _trainer_config(root, volumes):
    return {
        "tr_setup": {"model_name": "tiny", "autoconfigure": False,
                     "tr_val_split": 0.8, "seed": 0,
                     "ckpt_out_base": str(root / "ckpts"),
                     "tensorboard_log_dir": str(root / "logs")},
        "tr_config": {"optimizer": "SGD", "initial_lr": 1e-2,
                      "patch_size": [16, 16, 16], "batch_size": 4,
                      "max_steps_per_epoch": 2,
                      "max_val_steps_per_epoch": 1, "max_epoch": 2,
                      "num_dataloader_workers": 1,
                      "compute_dtype": "float32"},
        "model_config": dict(MODEL, kernel_sizes=[3, 3]),
        "dataset_config": {
            "min_bbox_percent": 0.97, "min_labeled_ratio": 0.15,
            "use_cache": False, "in_channels": 1, "volume_paths": [volumes],
            "targets": {
                "sheet": {"channels": 1, "activation": "sigmoid",
                          "loss_fn": "BCEDiceLoss"},
                "normals": {"channels": 3, "activation": "none",
                            "loss_fn": "MaskedCosineLoss"}}},
        "inference_config": {},
    }


def _files(root):
    """Every file under ``root``; a TensorBoard event file by its kind
    (its name holds the time and the writer's pid)."""
    return sorted(os.path.relpath(os.path.join(
        d, "events.out.tfevents" if f.startswith("events.out.tfevents")
        else f), root) for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory, volumes):
    """The trainer, 1 and 2 processes; each rank works in its own
    directory (``<root>/cwd/rank<r>``), the checkpoints and metrics go to
    ``<root>/ckpts`` and ``<root>/logs``."""
    tmp = tmp_path_factory.mktemp("dist_trainer")
    runs = {}
    for world in (1, 2):
        root = tmp / f"w{world}"
        runs[world] = (root, worker.launch(
            "trainer", world, {"config": _trainer_config(root, volumes),
                               "cwd": str(root / "cwd")}, tmp, f"tr{world}"))
    return runs


def test_two_process_trainer_losses_match_one_process(trainer_runs):
    _, (one,) = trainer_runs[1]
    _, two = trainer_runs[2]
    keys = [k for k in one["history"][0] if k.endswith("_loss")
            and k.startswith("train/")]
    assert keys
    for got in two:
        assert len(got["history"]) == len(one["history"]) == 2
        for h_got, h_want in zip(got["history"], one["history"]):
            for k in keys:
                np.testing.assert_allclose(h_got[k], h_want[k],
                                           rtol=STEP_TOL, err_msg=k)
        for name, want in one["params"].items():
            assert _rel_l2(got["params"][name], want) <= TRAINER_PARAM_TOL, \
                name


def test_only_rank_0_writes(trainer_runs):
    root1, _ = trainer_runs[1]
    root2, _ = trainer_runs[2]
    assert _files(root2 / "cwd" / "rank1") == []
    assert "tiny_final.pt" in _files(root2 / "cwd" / "rank0")
    # one writer: the same files as the single process, and the metrics
    # file holds each epoch's lines once
    for sub in ("ckpts", "logs"):
        assert _files(root2 / sub) == _files(root1 / sub), sub
    lines = [json.loads(x) for x in
             (root2 / "logs" / "tiny_metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines if "train/sheet_loss" in x] == [0, 1]


# ----------------------------------------------------------------------
# single-process behaviour of parallel/
# ----------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("names", ["jax", "torchrun"])
def test_initialize_reads_the_launchers_environment(monkeypatch, names):
    for key in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES", "NUM_PROCESSES", "JAX_PROCESS_ID",
                "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    port = _free_port()
    if names == "jax":
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"localhost:{port}")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
        monkeypatch.setenv("JAX_PROCESS_ID", "0")
    else:
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        monkeypatch.setenv("MASTER_PORT", str(port))
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("RANK", "0")
    try:
        assert dist.initialize() is False      # one process
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo"
        assert dist.process_count() == 1 and dist.is_main_process()
    finally:
        dist.shutdown()
    assert not torch.distributed.is_initialized()


def test_initialize_without_a_coordinator(monkeypatch):
    for key in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "MASTER_ADDR", "MASTER_PORT", "JAX_NUM_PROCESSES",
                "NUM_PROCESSES", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert dist.initialize() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        dist.initialize(num_processes=2)


def test_single_process_helpers():
    assert dist.process_batch_slice(8) == slice(0, 8)
    assert pad_batch_to_devices(3, 2) == 4
    assert pad_batch_to_devices(4, 2) == 4
    assert dist.global_rows(3) == (3, slice(0, 3))
    x = torch.arange(4.0, requires_grad=True)
    with dist.global_batch():
        assert dist.global_sum(x) is x and dist.batch_shards() == 1
    dist.sync_global_devices("nothing to wait for")


def test_a_group_of_one_steps_bit_for_bit_as_no_group():
    """chip_smoke.py phase 14a's check on the CPU: the collectives of a
    world of one (global sums in the losses, the gradient buckets, the
    broadcast) change no bit of two steps."""
    from mt3d_resenc_unet_torch.core.plan import (TaskHead,
                                                  plan_from_manual_config)
    from mt3d_resenc_unet_torch.models.network import ResEncUNet
    from mt3d_resenc_unet_torch.train.losses import build_task_losses
    from mt3d_resenc_unet_torch.train.step import (build_optimizer,
                                                   cosine_epoch_schedule,
                                                   make_train_step)
    plan = plan_from_manual_config(MODEL, PATCH, 1,
                                   [TaskHead(*t) for t in TASKS])
    batch = {k: torch.from_numpy(v) for k, v in _global_batch(4).items()}

    def run():
        model = ResEncUNet(plan, seed=5)
        opt = build_optimizer(model.parameters(), "AdamW",
                              cosine_epoch_schedule(1e-3, 10, 5))
        step = make_train_step(model, build_task_losses(LOSS_CFG),
                               {k: 1.0 for k in LOSS_CFG},
                               grad_accum_steps=2)
        metrics = [step(opt, batch) for _ in range(2)]
        return metrics, model.state_dict()

    plain_m, plain_p = run()
    try:
        dist.initialize(f"localhost:{_free_port()}", 1, 0, backend="gloo")
        group_m, group_p = run()
    finally:
        dist.shutdown()
    for a, b in zip(plain_m, group_m):
        assert {k: v.item() for k, v in a.items()} == \
            {k: v.item() for k, v in b.items()}
    for name, value in plain_p.items():
        assert torch.equal(value, group_p[name]), name


def test_bucketed_sum_keeps_every_gradient():
    """The buckets split by size and keep each gradient's place."""
    grads = [torch.randn(5), torch.randn(3, 4), torch.randn(7),
             torch.randn(2, 2)]
    buckets = list(dist._buckets(grads, 16 * 4))
    assert [len(b) for b in buckets] == [1, 1, 2]
    flat = [t for b in buckets for t in b]
    assert all(a is b for a, b in zip(flat, grads))
