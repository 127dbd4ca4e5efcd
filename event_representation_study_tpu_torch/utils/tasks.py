"""Throttled parallel task execution (a copy of the JAX package's
``utils/tasks.py``, the equivalent of ev-licious ``tools/task_manager.py``:
the semaphore-bounded ``multiprocessing.Pool`` of the Gen4 baking stage,
precompute_reps.py:444). Thread-based: the heavy work is I/O or device
calls, both of which release the GIL. :meth:`TaskManager.results` returns
the results in submission order."""
from __future__ import annotations

import concurrent.futures
import threading
from typing import Callable, List


class TaskManager:
    def __init__(self, total: int, max_workers: int = 8, queue_size: int = 16):
        self.total = total
        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=max_workers)
        self.sem = threading.Semaphore(queue_size)
        self.futures: List[concurrent.futures.Future] = []
        self.done = 0

    def submit(self, fn: Callable, *args, **kwargs):
        """Queue ``fn(*args, **kwargs)``; blocks while ``queue_size`` tasks
        are pending."""
        self.sem.acquire()

        def wrapped():
            try:
                return fn(*args, **kwargs)
            finally:
                self.sem.release()

        self.futures.append(self.pool.submit(wrapped))

    def results(self) -> list:
        out = [f.result() for f in self.futures]
        self.pool.shutdown()
        return out

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.pool.shutdown(wait=True)
