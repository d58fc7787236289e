"""Worker process of the port's multi-process CPU tests
(tests/test_torch_port_distributed.py, test_torch_port_infer_multiproc.py).

Started N times by a test, one process a rank, over gloo on the CPU:

    python tests/torch_port_dist_worker.py MODE --rank R --world N \
        --port P --inputs IN.pt --out OUT.pt

Modes: ``step`` (training steps of the port on this rank's shard of a
global batch), ``trainer`` (``Trainer.train`` from a config dict, each
rank in its own working directory ``<cwd>/rank<r>``), ``engine``
(``ZarrInferenceEngine.infer``), ``zio`` (disjoint parts of one chunk
written row by row). Each writes its
results to ``OUT`` with ``torch.save``. Imports torch and the port only.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mt3d_resenc_unet_torch.parallel import distributed as dist  # noqa: E402


def _model(inputs):
    from mt3d_resenc_unet_torch.core.plan import (TaskHead,
                                                  plan_from_manual_config)
    from mt3d_resenc_unet_torch.models.network import ResEncUNet
    plan = plan_from_manual_config(
        inputs["model_config"], inputs["patch"], 1,
        [TaskHead(*t) for t in inputs["tasks"]])
    model = ResEncUNet(plan)
    model.load_state_dict(inputs["params"])
    return model


def step(inputs):
    from mt3d_resenc_unet_torch.data.augment_device import (
        DeviceAugConfig, make_device_augment)
    from mt3d_resenc_unet_torch.train.losses import build_task_losses
    from mt3d_resenc_unet_torch.train.step import (build_optimizer,
                                                   cosine_epoch_schedule,
                                                   make_train_step,
                                                   multitask_loss)
    model = _model(inputs)
    losses = build_task_losses(inputs["loss_cfg"])
    weights = {k: 1.0 for k in inputs["loss_cfg"]}
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    sl = dist.process_batch_slice(len(batch["image"]))
    local = {k: v[sl] for k, v in batch.items()}
    # this rank's loss on its own samples alone (what per-rank averaging
    # would report), from the initial parameters
    with torch.no_grad():
        out = model(local["image"])
        local_loss = float(multitask_loss(
            out, {k: v for k, v in local.items() if k != "image"}, losses,
            weights)[0])
    generator = torch.Generator().manual_seed(1)
    augment = (make_device_augment(DeviceAugConfig(
        normal_keys=("normals",))) if inputs.get("augment") else None)
    opt = build_optimizer(model.parameters(), "AdamW",
                          cosine_epoch_schedule(1e-3, 10, 5))
    train_step = make_train_step(model, losses, weights,
                                 grad_accum_steps=inputs.get("accum", 1),
                                 generator=generator, augment_fn=augment)
    history = []
    for _ in range(inputs.get("steps", 1)):
        metrics = train_step(opt, local)
        history.append({k: float(v) for k, v in metrics.items()})
    return {"history": history, "local_loss": local_loss,
            "params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()}}


def trainer(inputs):
    from mt3d_resenc_unet_torch.train.trainer import Trainer
    cwd = os.path.join(inputs["cwd"], f"rank{dist.process_index()}")
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    out = Trainer(config_dict=inputs["config"], device="cpu",
                  verbose=False).train()
    return {"history": out["history"],
            "params": {k: v.detach().clone()
                       for k, v in out["model"].state_dict().items()}}


def engine(inputs):
    from mt3d_resenc_unet_torch.infer.engine import ZarrInferenceEngine
    eng = ZarrInferenceEngine(config_dict=inputs["config"], device="cpu")
    store = eng.infer()
    return {"store": store, "mode": eng.last_mode}


def zio(inputs):
    from mt3d_resenc_unet_torch.data.zio import open_zarr
    vol = open_zarr(inputs["path"], writable=True)
    rows, cols = vol.shape
    part = cols // dist.process_count()
    rank = dist.process_index()
    dist.sync_global_devices("zio_start")
    for r in range(rows):
        vol[r, rank * part:(rank + 1) * part] = np.full(
            part, 1 + r + 1000 * rank, vol.dtype)
    return {}


TIMEOUT_S = 180


def launch(mode, world, inputs, tmp_path, tag):
    """Run ``mode`` in ``world`` worker processes on ``inputs``; returns
    each rank's results. A worker that fails or outlives TIMEOUT_S fails
    the caller, and every worker is ended."""
    import socket
    import subprocess
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    path = str(tmp_path / f"{tag}_inputs.pt")
    torch.save(inputs, path)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS")}
    procs, outs = [], []
    for rank in range(world):
        outs.append(str(tmp_path / f"{tag}_r{rank}.pt"))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, mode, "--rank", str(rank),
             "--world", str(world), "--port", str(port), "--inputs", path,
             "--out", outs[-1]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("step", "trainer", "engine", "zio"))
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--inputs", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    torch.set_num_threads(2)
    if a.world > 1:
        assert dist.initialize(f"localhost:{a.port}", a.world, a.rank,
                               backend="gloo", timeout_s=120)
    inputs = torch.load(a.inputs, weights_only=False)
    result = globals()[a.mode](inputs)
    result.update(rank=dist.process_index(), world=dist.process_count(),
                  is_main=dist.is_main_process())
    torch.save(result, a.out)
    dist.sync_global_devices("done")
    dist.shutdown()


if __name__ == "__main__":
    main()
