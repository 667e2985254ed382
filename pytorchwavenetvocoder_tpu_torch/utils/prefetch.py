"""Background prefetch generator.

Equivalent of reference ``utils/utils.py:165-217`` but with the
``max_prefetch`` plumbing bug fixed: the reference's ``@background``
decorator dropped its argument, so the queue depth silently stayed at 1
(`utils.py:216`).  Here the decorator honors the requested depth, which
actually overlaps host-side feature loading with device steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class BackgroundGenerator(threading.Thread):
    """Wrap a generator; produce items on a daemon thread into a bounded queue."""

    def __init__(self, generator: Iterator, max_prefetch: int = 1) -> None:
        super().__init__()
        self.queue: queue.Queue = queue.Queue(max_prefetch)
        self.generator = generator
        self.exc: BaseException | None = None
        self.daemon = True
        self.start()

    def run(self) -> None:
        try:
            for item in self.generator:
                self.queue.put(item)
        except BaseException as e:  # surfaced from next(), not lost on the thread
            self.exc = e
        finally:
            self.queue.put(None)

    def next(self):
        next_item = self.queue.get()
        if next_item is None:
            # re-arm the sentinel: the producer thread is finished, so a
            # caller that catches the error and calls next() again must
            # see the same terminal signal, not block forever on get()
            self.queue.put(None)
            if self.exc is not None:
                raise self.exc
            raise StopIteration
        return next_item

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self


def background(max_prefetch: int = 1) -> Callable:
    """Decorator turning a generator function into a prefetched one."""

    def decorator(generator_fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            return BackgroundGenerator(generator_fn(*args, **kwargs),
                                       max_prefetch=max_prefetch)
        return wrapper

    return decorator
