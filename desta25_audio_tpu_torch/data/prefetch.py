"""Prefetching data loader: thread-pool collation and a batch pipeline
(port of ``desta25_audio_tpu/data/prefetch.py``).

The reference relies on torch DataLoader worker *processes* for its
CPU-bound collate (audio decode + STFT inside BaseCollateFn,
simple_dataset.py:139-243).  Here the heavy lifting releases the GIL (the
native C++ decode and resample, ``native/``) and the mel runs on the device
inside the train step, so a thread pool suffices: a producer thread cuts the
dataset into batches of items, N worker threads collate them (numpy only:
no CUDA work leaves the consumer's thread) while the device runs the
previous step, and bounded queues apply backpressure.  Batches are emitted
in order, so training stays deterministic.

A departure from the JAX loader, on purpose: there a collate exception ends
its worker thread without a word to the consumer, which then waits forever;
here the first exception of any thread is re-raised in the consumer, and
the other threads stop.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List

from .dataset import AudioTextDataset, CollateFn

_POLL_S = 0.1


class PrefetchLoader:
    """Iterable over collated batches with background workers.

    depth: the most batches buffered ahead of the consumer.
    """

    def __init__(self, dataset: AudioTextDataset, collate: CollateFn,
                 batch_size: int, epoch: int = 0, num_workers: int = 4,
                 depth: int = 4, drop_last: bool = True):
        self.dataset = dataset
        self.collate = collate
        self.batch_size = batch_size
        self.epoch = epoch
        self.num_workers = max(num_workers, 1)
        self.depth = depth
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        item_q: "queue.Queue" = queue.Queue(maxsize=self.depth * 2)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        seq_lock = threading.Lock()
        results: Dict[int, Dict[str, Any]] = {}
        next_emit = [0]
        errors: List[BaseException] = []

        def put(q: "queue.Queue", obj) -> bool:
            """Put unless the loader stopped meanwhile (False then)."""
            while not stop.is_set():
                try:
                    q.put(obj, timeout=_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def fail(e: BaseException) -> None:
            errors.append(e)
            stop.set()

        def producer():
            try:
                buf: List[Dict[str, Any]] = []
                seq = 0
                for item in self.dataset.iter_valid(self.epoch):
                    if stop.is_set():
                        return
                    buf.append(item)
                    if len(buf) == self.batch_size:
                        if not put(item_q, (seq, buf)):
                            return
                        seq += 1
                        buf = []
                if buf and not self.drop_last:
                    if not put(item_q, (seq, buf)):
                        return
                for _ in range(self.num_workers):
                    if not put(item_q, None):
                        return
            except BaseException as e:  # noqa: BLE001 -- to the consumer
                fail(e)

        def worker():
            try:
                while not stop.is_set():
                    try:
                        task = item_q.get(timeout=_POLL_S)
                    except queue.Empty:
                        continue
                    if task is None:
                        put(out_q, None)
                        return
                    seq, items = task
                    batch = self.collate(items)
                    # in-order emission so training stays deterministic
                    with seq_lock:
                        results[seq] = batch
                        while next_emit[0] in results:
                            if not put(out_q, (next_emit[0],
                                               results.pop(next_emit[0]))):
                                return
                            next_emit[0] += 1
            except BaseException as e:  # noqa: BLE001 -- to the consumer
                fail(e)

        threads = [threading.Thread(target=producer, daemon=True)]
        threads += [threading.Thread(target=worker, daemon=True)
                    for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        finished_workers = 0
        try:
            while finished_workers < self.num_workers:
                try:
                    got = out_q.get(timeout=_POLL_S)
                except queue.Empty:
                    if errors:
                        raise errors[0]
                    continue
                if got is None:
                    finished_workers += 1
                    continue
                yield got[1]
            if errors:
                raise errors[0]
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)
