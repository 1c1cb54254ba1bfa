"""Micro-batching request aggregator for serving.

The port's own copy of ``debias_vision_lang_tpu/serve/batcher.py`` (pure
Python: threads, futures, queues); ``tests/test_torch_standalone.py`` holds
its code to the original.  Device throughput grows with batch size, so the
batcher turns a stream of single-item requests into device-sized batches:
the first request opens a window of ``max_wait_ms``; everything that
arrives inside it (up to ``max_batch``) rides the same device launch.

Deterministic contract: ``run_batch`` receives the items in arrival order
and must return one result per item along axis 0 (or a list).  Exceptions
from ``run_batch`` propagate to every future of that batch.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence


class MicroBatcher:
    """Background-thread request aggregator.

    ``submit(item)`` returns a ``concurrent.futures.Future``; results are the
    per-item slices of ``run_batch``'s output.
    """

    def __init__(
        self,
        run_batch: Callable[[List[Any]], Sequence[Any]],
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
        name: str = "microbatch",
        finalize: Optional[Callable[[Any, int], Sequence[Any]]] = None,
    ):
        """With ``finalize``, batching is a two-stage pipeline: ``run_batch``
        only DISPATCHES (e.g. stages the batch and launches the async device
        call, returning the device array) and ``finalize(result, n)`` blocks
        for and splits the per-item outputs on a second thread — so batch
        k+1's host staging and H2D overlap batch k's device compute and
        fetch (classic double buffering; CUDA launches are async)."""
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._run_batch = run_batch
        self._finalize = finalize
        self._max_batch = int(max_batch)
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()
        self.n_batches = 0
        self.n_items = 0
        # dispatch time (worker thread) and finalize time (finalizer
        # thread) are separate counters — each touched by exactly one
        # thread — and summed in stats.  In two-stage mode dispatch is
        # staging + launch; the device+fetch time lands in finalize_seconds.
        self.run_seconds = 0.0
        self.finalize_seconds = 0.0
        self._thread = threading.Thread(target=self._worker, name=name,
                                        daemon=True)
        self._thread.start()
        self._fq: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=2)
        self._fthread: Optional[threading.Thread] = None
        if finalize is not None:
            self._fthread = threading.Thread(target=self._finalizer,
                                             name=name + "-fin", daemon=True)
            self._fthread.start()

    def submit(self, item: Any) -> Future:
        fut: Future = Future()
        # closed-check and enqueue are one atomic step: an item enqueued
        # after close()'s sentinel would never be processed and its future
        # would hang forever (close() takes the same lock)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.put((item, fut))
        return fut

    @property
    def stats(self) -> dict:
        """Cumulative batch-formation metrics (mean batch size is the one
        that matters: it is the device-utilization multiplier)."""
        return {
            "batches": self.n_batches,
            "items": self.n_items,
            "mean_batch": round(self.n_items / max(1, self.n_batches), 2),
            "run_seconds": round(self.run_seconds + self.finalize_seconds, 3),
        }

    def close(self, timeout: float = 5.0) -> None:
        """Drain outstanding work and stop the worker."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # sentinel; everything enqueued before it drains
        self._thread.join(timeout=timeout)

    # -- worker --------------------------------------------------------------

    def _collect(self) -> Optional[List[tuple]]:
        """Block for the first request, then drain the arrival window."""
        head = self._q.get()
        if head is None:
            return None
        batch = [head]
        deadline = time.monotonic() + self._max_wait_s
        while len(batch) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:  # close() while collecting: flush what we have
                self._q.put(None)
                break
            batch.append(nxt)
        return batch

    def _worker(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                if self._fthread is not None:
                    self._fq.put(None)
                    self._fthread.join(timeout=5.0)
                return
            items = [item for item, _ in batch]
            futures = [fut for _, fut in batch]
            try:
                t0 = time.monotonic()
                results = self._run_batch(items)
                self.run_seconds += time.monotonic() - t0
                self.n_batches += 1
                self.n_items += len(items)
            except Exception as e:  # noqa: BLE001 - propagate to callers
                _fail_all(futures, e)
                continue
            if self._finalize is not None:
                # hand off to the finalizer thread; the bounded queue gives
                # backpressure (at most 2 batches in flight on the device)
                self._fq.put((results, futures))
                continue
            self._distribute(futures, results)

    def _distribute(self, futures, results) -> None:
        if len(results) != len(futures):
            _fail_all(futures, RuntimeError(
                f"run_batch returned {len(results)} results "
                f"for {len(futures)} items"))
            return
        for fut, res in zip(futures, results):
            # a consumer may have cancel()ed while the batch was pending;
            # set_result on a cancelled future raises InvalidStateError and
            # would kill this thread, hanging every later request
            if fut.set_running_or_notify_cancel():
                fut.set_result(res)

    def _finalizer(self) -> None:
        while True:
            entry = self._fq.get()
            if entry is None:
                return
            handle, futures = entry
            try:
                t0 = time.monotonic()
                results = self._finalize(handle, len(futures))
                self.finalize_seconds += time.monotonic() - t0
            except Exception as e:  # noqa: BLE001
                _fail_all(futures, e)
                continue
            self._distribute(futures, results)


def _fail_all(futures, err: Exception) -> None:
    """set_exception tolerant of consumer-side cancel() (see _distribute)."""
    for fut in futures:
        if fut.set_running_or_notify_cancel():
            fut.set_exception(err)
