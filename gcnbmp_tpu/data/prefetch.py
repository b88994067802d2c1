"""Background-thread batch prefetching.

The reference's SerialIterator prepares batches synchronously on the
host between device steps (train_ddi_modify_eval2.py:556-558).  Here a
small thread pool packs/pads the next batches and stages them to the
device while the current step runs, so host featurization/packing
overlaps device compute — the standard input-pipeline design the
Chainer stack lacked.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import jax


class PrefetchIterator:
    """Wrap a batch iterator; stage ``depth`` batches ahead, optionally
    transferring each to the device via ``transfer``.

    ``workers`` > 1 runs the transfer stage on a thread pool (order
    preserved): when a staged transfer takes longer than the device
    step, concurrent transfers keep the pipeline compute-bound.  Batch *production* stays on the single producer thread
    (the upstream iterator is rarely thread-safe).

    Exceptions on any worker are re-raised at the consumer.
    """

    _SENTINEL = object()

    def __init__(
        self,
        iterator: Iterator,
        depth: int = 2,
        transfer: Optional[Callable] = None,
        workers: int = 1,
    ):
        self._it = iterator
        self._transfer = transfer or (lambda b: b)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, workers))
        self._err: Optional[BaseException] = None
        self._done = False
        self._pool = (
            ThreadPoolExecutor(max_workers=workers)
            if (workers > 1 and transfer is not None) else None
        )
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            if self._pool is None:
                for batch in self._it:
                    self._q.put((None, self._transfer(batch)))
            else:
                # queue futures in order; the bounded queue applies
                # backpressure to the producer
                for batch in self._it:
                    self._q.put((self._pool.submit(self._transfer, batch), None))
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is self._SENTINEL:
            self._done = True
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        fut, value = item
        return value if fut is None else fut.result()


def device_put_batch(batch, device=None):
    """Transfer every array field of a (dataclass-style) batch to the
    device; non-blocking (jax.device_put is async)."""
    import dataclasses

    import numpy as np

    def put(x):
        if isinstance(x, np.ndarray):
            return jax.device_put(x, device)
        return x

    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(
            batch,
            **{
                f.name: put(getattr(batch, f.name))
                for f in dataclasses.fields(batch)
            },
        )
    return jax.tree.map(put, batch)
