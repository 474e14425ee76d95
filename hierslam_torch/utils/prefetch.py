"""Background frame prefetching (a port-owned copy of
``hierslam_tpu/utils/prefetch.py``).

A lookahead thread loads the next frames while the main thread steps the
current one.  The port's JPEG and PNG decoders (``utils/image_io.py``) are
partly Python (the Huffman walk), which holds the interpreter lock, so the
overlap is only with the main thread's waits on the GPU."""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class Prefetcher:
    """Iterate ``load(i)`` for i in [start, end) with ``depth`` lookahead."""

    def __init__(self, load: Callable[[int], object], start: int, end: int, depth: int = 2):
        self.load = load
        self.indices = list(range(start, end))
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.err: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for i in self.indices:
                self.q.put((i, self.load(i)))
        except BaseException as e:  # surfaced on the consumer side
            self.err = e
        finally:
            self.q.put(None)

    def __iter__(self) -> Iterator:
        while True:
            item = self.q.get()
            if item is None:
                if self.err is not None:
                    raise self.err
                return
            yield item
