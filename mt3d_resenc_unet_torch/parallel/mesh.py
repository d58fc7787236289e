"""Batch sizing for data parallelism.

The port of ``mt3d_resenc_unet_tpu/parallel/mesh.py``. There a
``jax.sharding.Mesh`` spans the devices, ``shard_batch`` splits the batch
over its data axis and ``replicate`` copies the parameters. Here each rank
drives one device, so the mesh is the process group
(``parallel/distributed.py``): a rank's batch is its shard, and
``broadcast_params`` replicates. What stays is the rounding of the batch.
"""

from __future__ import annotations


def pad_batch_to_devices(n: int, n_devices: int) -> int:
    """Smallest multiple of n_devices >= n (per-device batch must be equal)."""
    return ((n + n_devices - 1) // n_devices) * n_devices
