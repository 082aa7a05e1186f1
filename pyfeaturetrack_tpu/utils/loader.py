"""Threaded frame loader: decode-ahead PNM ingestion for the serving
path.

Reference parity: the reference's examples load each frame with a
blocking ``pgmReadFile`` right before tracking it (SURVEY.md section
3.5). At serving rates the tracker dispatch takes tens of
microseconds while a disk read + decode takes tens of microseconds to
milliseconds — left serial, the *loader* becomes the pipeline's
bottleneck. :class:`FrameLoader` moves read+decode into a worker pool
(the native codec in native/pnm_codec.cpp releases the GIL during file
reads and runs the parse in C) and yields frames strictly in order, a
bounded readahead window ahead of consumption.

Composes with the rest of the serving stack::

    frames = FrameLoader(sorted(glob.glob("seq/*.pgm")))
    table = serve_stream(frames, n_features=200, stage_uint8=True)

The loader yields host uint8 arrays; device staging stays the job of
``serving`` (plain asarray feed or prefetch_to_device — see the
measured staging rules in serving.py's module docstring).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from ..errors import KLTError
from .io import read_image

_SENTINEL = object()


class FrameLoader:
    """Ordered decode-ahead iterator over a list of image paths.

    ``readahead`` bounds how many decoded frames may sit waiting (memory
    cap: readahead x frame bytes); ``workers`` decodes that window
    concurrently — useful because file reads release the GIL and PGM
    ascii decode runs in native code. ``reader`` defaults to
    :func:`utils.io.read_image` (PGM via the native codec, anything
    else via PIL -> grayscale) and may be any path -> ndarray callable
    (e.g. an actual video decoder).

    Iteration is strictly source-order. A reader exception is re-raised
    at the consuming ``next()`` for the frame that failed (decode-ahead
    of later frames may already have happened; their results are
    dropped). The loader is single-pass: iterating twice raises.
    """

    def __init__(self, paths: Sequence, readahead: int = 8,
                 workers: int = 2,
                 reader: Optional[Callable] = None):
        if readahead < 1:
            raise KLTError(
                f"(FrameLoader) readahead must be >= 1, got {readahead}")
        if workers < 1:
            raise KLTError(
                f"(FrameLoader) workers must be >= 1, got {workers}")
        self._paths = list(paths)
        self._readahead = int(readahead)
        self._workers = int(workers)
        self._reader = reader if reader is not None else read_image
        self._started = False

    def __len__(self) -> int:
        return len(self._paths)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._started:
            raise KLTError("(FrameLoader) single-pass iterator consumed "
                           "twice — construct a new loader")
        self._started = True
        if not self._paths:
            return
        # futures queue keeps submission order == yield order; its bound
        # is the readahead window (submitter blocks when full)
        fq: queue.Queue = queue.Queue(maxsize=self._readahead)
        cancelled = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self._workers,
                                  thread_name_prefix="pft-decode")

        def submit_all():
            for p in self._paths:
                if cancelled.is_set():
                    return
                fq.put(pool.submit(self._reader, p))
            fq.put(_SENTINEL)

        feeder = threading.Thread(target=submit_all, daemon=True,
                                  name="pft-loader-feed")
        feeder.start()
        try:
            while True:
                item = fq.get()
                if item is _SENTINEL:
                    return
                yield item.result()  # re-raises the reader's exception
        finally:
            cancelled.set()
            while True:  # unblock the feeder, drop pending decodes
                try:
                    item = fq.get_nowait()
                except queue.Empty:
                    break
                if item is not _SENTINEL:
                    item.cancel()
            pool.shutdown(wait=False)


def load_frames(paths: Sequence, **kwargs) -> list:
    """Eagerly decode ``paths`` with the FrameLoader pool; returns a
    list of uint8 arrays (the batch-shaped convenience the CLI and
    chunked drivers want)."""
    return list(FrameLoader(paths, **kwargs))
