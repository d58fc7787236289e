"""Host input pipeline: threaded sample loading + pinned device prefetch.

The port of ``mt3d_resenc_unet_tpu/data/pipeline.py``. ``batch_iterator``
and ``train_val_split`` are copies: a thread pool decodes and augments
samples (numpy releases the GIL in its large operations) and stacks them
into host batches. ``device_prefetch`` replaces the JAX ``device_put``
queue: a producer thread copies each host batch into freshly allocated
pinned host tensors and issues ``non_blocking`` host-to-device copies on a
side CUDA stream without waiting for them, so the copy of batch k+1
overlaps the step on batch k.
No mesh and no sharding: one device (DDP is ROADMAP queue 1 #9).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Sequence

import numpy as np
import torch


class _EndOfData:
    pass


_EOD = _EndOfData()


def batch_iterator(
    dataset,
    indices: Sequence[int],
    batch_size: int,
    *,
    num_threads: int = 8,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield stacked host batches, samples decoded by a thread pool."""
    indices = list(indices)
    if drop_last:
        usable = (len(indices) // batch_size) * batch_size
        indices = indices[:usable]
    if not indices:
        return
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        # submit a rolling window of sample fetches
        window = num_threads * 2 + batch_size
        futures = {}
        it = iter(range(len(indices)))
        submitted = 0
        for _ in range(min(window, len(indices))):
            i = next(it)
            futures[i] = pool.submit(dataset.__getitem__, indices[i])
            submitted += 1
        n_batches = len(indices) // batch_size
        for b in range(n_batches):
            samples = []
            for j in range(b * batch_size, (b + 1) * batch_size):
                samples.append(futures.pop(j).result())
                if submitted < len(indices):
                    i = next(it)
                    futures[i] = pool.submit(dataset.__getitem__, indices[i])
                    submitted += 1
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _to_host_tensor(a: np.ndarray, bf16: bool, pin: bool) -> torch.Tensor:
    """A host batch array as a torch tensor (pinned for the card), cast to
    bf16 when asked and floating."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if bf16 and t.is_floating_point():
        t = t.to(torch.bfloat16)
    if pin:
        t = t.pin_memory()
    return t


def device_prefetch(
    host_batches: Iterable[Dict[str, np.ndarray]],
    device,
    prefetch: int = 2,
    bf16_keys: Sequence[str] = (),
) -> Iterator[Dict[str, torch.Tensor]]:
    """Move host batches to ``device`` ahead of consumption.

    On a CUDA device a producer thread pins each batch into fresh pinned
    tensors, copies it with ``non_blocking=True`` on a side stream and
    records an event after the copies; it does not wait for them. The
    queued item holds the pinned tensors until the consumer's stream has
    been made to wait on that event, and past that torch's pinned-memory
    allocator, which records the copy's stream for every non-blocking copy
    from pinned memory, hands the buffer out again only after the copy has
    finished, so a pinned buffer is never rewritten while its copy is in
    flight. ``record_stream`` keeps the caching allocator from handing the
    batch's device memory to another stream while the consumer still uses
    it. At most ``prefetch`` batches wait in the queue.
    Floating arrays under ``bf16_keys`` are cast to bf16 on the host (the
    wire format's image). A producer exception is re-raised in the
    consumer (JAX pipeline.py:102-121)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    bf16_keys = frozenset(bf16_keys)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            if cuda:
                torch.cuda.set_device(device)
                side = torch.cuda.Stream(device)
            for batch in host_batches:
                host = {k: _to_host_tensor(v, k in bf16_keys, cuda)
                        for k, v in batch.items()}
                if cuda:
                    with torch.cuda.stream(side):
                        dev = {k: v.to(device, non_blocking=True)
                               for k, v in host.items()}
                        done = torch.cuda.Event()
                        done.record(side)
                else:
                    dev, done = host, None
                if not put((dev, host, done)):
                    break
                del host
        except BaseException as e:  # noqa: BLE001 - forwarded, not swallowed
            put(e)
        finally:
            close = getattr(host_batches, "close", None)
            if close is not None:
                close()
            put(_EOD)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, _EndOfData):
                break
            if isinstance(item, BaseException):
                raise item
            batch, host, done = item
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for v in batch.values():
                    v.record_stream(stream)
            del item, host
            yield batch
    finally:
        stop.set()


def train_val_split(n: int, split: float, seed: int = 0):
    """Shuffled index split (reference: train.py:99-107)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    cut = int(np.floor(split * n))
    return idx[:cut].tolist(), idx[cut:].tolist()
