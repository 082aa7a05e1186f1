"""Live-video serving: overlapped host->device staging for the
device-resident sequence loop.

Reference parity: the reference (SURVEY.md section 3.5, example3.py)
reads each frame from disk synchronously before tracking it — fine on a
CPU where "transfer" is a pointer. On an accelerator the frame must
cross the host link first, so frames can ship uint8 and the next
frame's transfer overlaps the current frame's compute.

This module provides that overlap:

- :class:`StreamingTracker` — an incremental (push-style) wrapper over
  ``models.device_sequence``: feed frames as they arrive, results stay
  device-resident; pull the stacked track table at the end (or every
  ``emit_every`` frames when the deployment needs live positions and
  can afford the d2h).
- :func:`prefetch_to_device` — a bounded background-thread iterator
  that stages upcoming frames with ``jax.device_put`` and forces the
  transfer to completion *in the worker thread*, so the main thread's
  ``next()`` returns an already-resident array.

Design notes:
- JAX's own dispatch is already asynchronous: ``jnp.asarray`` staging
  enqueues the transfer and returns, so the plain synchronous-looking
  feed loop already overlaps h2d with compute.
- The staging THREAD is for slow *sources* (a decoder that takes ms
  per frame), not for h2d. Hence ``prefetch=0`` is the default; raise
  it only when the frame source itself blocks.
- Ship frames uint8 (``stage_uint8=True``): 4x less link traffic than
  float32; the f32 cast happens inside the jitted step where it fuses
  for free.
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import Iterable, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .config import TrackerConfig, create_config
from .errors import KLTError
from .models.device_sequence import (_sequence_step_body,
                                     select_step_device,
                                     sequence_chain_device,
                                     sequence_step_device,
                                     warn_selection_exhausted)
from .ops.select_device import DEFAULT_TOP_K
from .utils.staging import stage_raw

_STOP = object()


def prefetch_to_device(frames: Iterable, depth: int = 2,
                       device: Optional[jax.Device] = None,
                       stage_dtype=np.float32) -> Iterator[jax.Array]:
    """Iterate ``frames`` with up to ``depth`` frames staged on device
    ahead of consumption.

    A daemon thread pulls host frames, ``device_put``s them and blocks
    on the transfer *there*, so the consumer overlap-hides h2d latency
    behind whatever it does between ``next()`` calls (normally the
    tracking dispatch). Exceptions in the source iterator are re-raised
    at the consuming ``next()``.

    ``stage_dtype=np.uint8`` ships 8-bit frames over the host link (4x
    less transfer than float32) and leaves the f32 cast to the consuming jitted
    step, where it fuses into the pyramid build for free.
    """
    if depth < 1:
        raise KLTError(f"(prefetch_to_device) depth must be >= 1, got {depth}")
    dev = device if device is not None else jax.devices()[0]
    q: queue.Queue = queue.Queue(maxsize=depth)
    cancelled = threading.Event()

    def worker():
        try:
            for f in frames:
                if cancelled.is_set():
                    return
                arr = jax.device_put(np.asarray(f, stage_dtype), dev)
                arr.block_until_ready()  # complete transfer in THIS thread
                q.put(arr)
                if cancelled.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            q.put(e)
            return
        q.put(_STOP)

    t = threading.Thread(target=worker, daemon=True,
                         name="pft-prefetch")
    t.start()

    try:
        while True:
            item = q.get()
            if item is _STOP:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # consumer abandoned the stream (break / exception / GC): unblock
        # a producer stuck on the full queue so it can exit and release
        # the staged frames + source iterator
        cancelled.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break


class _StreamingBase:
    """Shared push-feed machinery for the streaming trackers: chain
    buffering, device-history bookkeeping with host migration on pull,
    exhaustion surfacing, and the flush/block/table/drain lifecycle.
    Subclasses define the wire format (``_coerce``), first-frame
    selection (``_start``), the advance program (``_advance``), and the
    host row layout (``_host_rows``/``_empty_rows``)."""

    _name = "StreamingTracker"

    def __init__(self, cfg, n_features, replace_lost, top_k, chain):
        if chain < 1:
            raise KLTError(f"({self._name}) chain must be >= 1, got {chain}")
        self.cfg = (cfg if cfg is not None else create_config()).replace(
            sequentialMode=True).validated_window()
        self.n_features = int(n_features)
        self.replace_lost = bool(replace_lost)
        self.top_k = int(top_k)
        self.chain = int(chain)
        self._pyr = None
        self._aff = None
        self._state = None          # (x, y, val) device arrays
        self._pending: list = []    # staged items awaiting a chain
        self._chunks: list = []     # device history chunks
        self._host_chunks: list = []  # history already pulled to host
        self._exhausted = None
        self.n_frames = 0

    def _note_exhausted(self, ex) -> None:
        self._exhausted = (ex if self._exhausted is None
                           else self._exhausted | ex)

    def feed(self, item) -> Optional[tuple]:
        """Process one input (device array or host ndarray)."""
        item = self._coerce(item if isinstance(item, jax.Array)
                            else stage_raw(item))
        if self._state is None:
            self._start(item)
        else:
            self._pending.append(item)
            if len(self._pending) >= self.chain:
                self._advance(self._pending)
                self._pending = []
        self.n_frames += 1
        return None

    def flush(self) -> None:
        """Force out any buffered partial chain (ends a latency
        window); ``_advance`` runs tails per-step so each distinct tail
        length does not compile its own chained program."""
        if self._pending:
            self._advance(self._pending)
            self._pending = []

    def block(self) -> None:
        """Wait for all dispatched work (throughput-benchmark fence)."""
        self.flush()
        if self._state is not None:
            jax.block_until_ready(self._state[2])

    def _migrate_history(self) -> None:
        """Pull device history chunks to host (one d2h per chunk) so
        device memory stays bounded by the emit/pull cadence, and each
        table() only transfers rows produced since the previous pull."""
        if self._exhausted is not None and bool(self._exhausted):
            warn_selection_exhausted(self._name, self.top_k)
            self._exhausted = jnp.asarray(False)  # warn once per pull
        for c in self._chunks:
            self._host_chunks.append(self._host_rows(c))
        self._chunks = []

    def table(self) -> tuple:
        """(x, y, val) numpy arrays, frames stacked on axis 0. History
        rows migrate to host on each call, so device memory is bounded
        by the pull cadence; the host copy still grows with the stream
        — long-lived servers should use :meth:`drain`."""
        self.flush()
        self._migrate_history()
        if not self._host_chunks:
            raise KLTError(f"({self._name}.table) no frames fed yet")
        cols = [[c[j] for c in self._host_chunks] for j in range(3)]
        return tuple(np.concatenate(col, axis=0) for col in cols)

    def drain(self) -> tuple:
        """Like :meth:`table`, but returns ONLY the rows accumulated
        since the previous drain/construction and releases them —
        bounded memory for unbounded (24/7) streams. An empty interval
        returns zero-row arrays."""
        self.flush()
        self._migrate_history()
        if not self._host_chunks:
            return self._empty_rows()
        cols = [[c[j] for c in self._host_chunks] for j in range(3)]
        self._host_chunks = []
        return tuple(np.concatenate(col, axis=0) for col in cols)


class StreamingTracker(_StreamingBase):
    """Push-style live tracking: ``feed`` frames as they arrive, state
    stays device-resident between calls.

    The first fed frame runs feature selection; every later frame runs
    the full track -> affine-check -> replace-lost step
    (``models.device_sequence``). Frames are buffered until ``chain``
    are available, then advanced in ONE dispatched program
    (amortizing the per-dispatch cost); call
    :meth:`flush` to force out a partial chain (e.g. at end of stream
    or when latency matters more than throughput).

    :meth:`table`/:meth:`drain` return [n_frames, n_features] numpy
    arrays (the FeatureTable layout of track_sequence_device).
    ``emit_every`` > 0 auto-pulls and returns the table every
    that-many frames from :meth:`feed` — use only where the deployment
    genuinely needs live positions (each pull waits for the device).
    """

    _name = "StreamingTracker"

    def __init__(self, cfg: Optional[TrackerConfig] = None,
                 n_features: int = 150, replace_lost: bool = True,
                 top_k: int = DEFAULT_TOP_K, chain: int = 1,
                 emit_every: int = 0):
        super().__init__(cfg, n_features, replace_lost, top_k, chain)
        self.emit_every = int(emit_every)

    def _coerce(self, frame) -> jax.Array:
        return frame

    def _start(self, frame) -> None:
        self._pyr, x, y, val, self._aff, self._exhausted = \
            select_step_device(frame, self.cfg, self.n_features,
                               self.top_k)
        self._state = (x, y, val)
        self._chunks.append((x, y, val))

    def _advance(self, frames: list) -> None:
        # a full chain uses the one compiled k-frame program; partial
        # chains (flush/emit tails) fall back to per-step calls (same
        # policy as track_sequence_device's tail handling)
        if len(frames) == self.chain and self.chain > 1:
            x, y, val = self._state
            (self._pyr, hist, (x, y, val), self._aff,
             ex) = sequence_chain_device(
                self._pyr, tuple(frames), x, y, val, self.cfg,
                self.replace_lost, self.top_k, self._aff)
            self._chunks.append(hist)
            self._state = (x, y, val)
            self._note_exhausted(ex)
            return
        for f in frames:
            x, y, val = self._state
            (self._pyr, x, y, val, self._aff,
             ex) = sequence_step_device(
                self._pyr, f, x, y, val, self.cfg,
                self.replace_lost, self.top_k, self._aff)
            self._chunks.append((x, y, val))
            self._state = (x, y, val)
            self._note_exhausted(ex)

    def _host_rows(self, c) -> tuple:
        return tuple(np.atleast_2d(np.asarray(c[j])) for j in range(3))

    def _empty_rows(self) -> tuple:
        n = self.n_features
        return (np.empty((0, n), np.float32),
                np.empty((0, n), np.float32),
                np.empty((0, n), np.int32))

    def feed(self, frame) -> Optional[tuple]:
        """Process one frame. Returns the stacked numpy table so far
        iff ``emit_every`` fired, else None."""
        super().feed(frame)
        if self.emit_every > 0 and self.n_frames % self.emit_every == 0:
            self.flush()
            return self.table()
        return None


@functools.partial(jax.jit, static_argnames=("cfg", "n_features", "top_k"))
def _select_batch(imgs, cfg, n_features: int, top_k: int):
    return jax.vmap(
        lambda im: select_step_device(im, cfg, n_features, top_k))(imgs)


@functools.partial(jax.jit, static_argnames=("cfg", "replace_lost",
                                             "top_k", "n_steps",
                                             "stream_mesh"))
def _step_batch(pyr, imgs, x, y, val, cfg, replace_lost: bool,
                top_k: int, aff, n_steps: int = 1, stream_mesh=None):
    """Advance every stream ``n_steps`` frames in ONE program: the
    shared per-frame body (track -> affine check) over the stream axis,
    then a BATCH-WIDE cond-gated refill. ``imgs`` is a tuple of n_steps
    [B, H, W] frame batches. The per-stream body is vmapped over the
    stream axis; on CUDA its LK levels run the Pallas level kernel, which
    takes the stream axis as one more grid dimension.

    The refill gate lives OUTSIDE the per-stream body on purpose: a
    lax.cond with a batched predicate lowers to select (both branches
    always run), so gating per-stream inside the body would pay the
    full selection cost (eig map + top-K sort) every frame. One scalar
    any-stream-lost predicate per frame step preserves the skip; when
    it fires, the refill is an exact identity on streams with nothing
    lost (same argument as models/chunked.track_chunks_batched)."""
    from .features import reset_affine
    from .models.device_sequence import _selection_eig_from_pyr
    from .ops.select_device import select_features_from_eig_device

    def track_one(p, im, xx, yy, vv, af):
        return _sequence_step_body(p, im, xx, yy, vv, cfg, False,
                                   top_k, af)

    def track_tick(pyr, img_b, x, y, val, aff):
        pyr, x, y, val, aff, _ = jax.vmap(track_one)(
            pyr, img_b, x, y, val, aff)
        return pyr, x, y, val, aff

    imgs_b = jnp.stack(imgs, axis=0)          # [n_steps, B, H, W]
    hx, hy, hv = [], [], []
    exhausted = jnp.asarray(False)
    for i in range(n_steps):
        pyr, x, y, val, aff = track_tick(pyr, imgs_b[i], x, y, val, aff)
        if replace_lost:
            def refill(op, i=i):
                xx, yy, vv, av, ex = op
                def one(im, p, sx, sy, sv):
                    eig = _selection_eig_from_pyr(im, p, cfg)
                    return select_features_from_eig_device(
                        eig, sx, sy, sv, cfg, replacing=True,
                        top_k=top_k)
                if stream_mesh is not None:
                    # stream-sharded serving: refill each device's
                    # streams LOCALLY under shard_map — without it the
                    # partitioner all-gathers the per-stream eig maps
                    # to sort top_k ([B, 255744] f32 at 480x640, the
                    # only non-trivial collective in the whole tick;
                    # parallel/scaling.predict_scaling_efficiency
                    # flagged it)
                    from jax.experimental.shard_map import shard_map
                    from jax.sharding import PartitionSpec as P
                    from .parallel.sharding import FRAME_AXIS

                    def local(im, p, sx, sy, sv):
                        rx, ry, rv, _, exs = jax.vmap(one)(
                            jnp.asarray(im, jnp.float32), p, sx, sy, sv)
                        return rx, ry, rv, exs

                    fspec = P(FRAME_AXIS)
                    ispec = P(FRAME_AXIS, None, None)
                    rx, ry, rv, exs = shard_map(
                        local, mesh=stream_mesh,
                        in_specs=(ispec,
                                  jax.tree.map(lambda a: ispec, pyr),
                                  fspec, fspec, fspec),
                        out_specs=(fspec, fspec, fspec, fspec),
                        check_rep=False)(
                        imgs_b[i], pyr, xx, yy, vv)
                else:
                    rx, ry, rv, _, exs = jax.vmap(one)(
                        jnp.asarray(imgs_b[i], jnp.float32), pyr,
                        xx, yy, vv)
                if av is not None:
                    av = jax.vmap(reset_affine)(av, vv < 0)
                return rx, ry, rv, av, ex | jnp.any(exs)

            x, y, val, aff, exhausted = lax.cond(
                jnp.any(val < 0), refill, lambda op: op,
                (x, y, val, aff, exhausted))
        hx.append(x)
        hy.append(y)
        hv.append(val)
    hist = (jnp.stack(hx, axis=1), jnp.stack(hy, axis=1),
            jnp.stack(hv, axis=1))            # [B, n_steps, N]
    return pyr, hist, (x, y, val), aff, exhausted


class BatchedStreamingTracker(_StreamingBase):
    """Lockstep serving for B independent camera streams: every
    :meth:`feed` takes a [B, H, W] frame batch (one new frame per
    stream) and ONE vmapped device program advances all streams, with
    full per-stream replace-lost and affine-consistency semantics.

    Per-stream math is IDENTICAL to :class:`StreamingTracker` (shared
    `_sequence_step_body`); the history layout gains a stream axis:
    :meth:`table`/:meth:`drain` return [n_frames, B, n_features].
    ``chain`` buffers that many ticks and advances them in one program.
    """

    _name = "BatchedStreamingTracker"

    def __init__(self, cfg: Optional[TrackerConfig] = None,
                 n_streams: int = 8, n_features: int = 150,
                 replace_lost: bool = True, top_k: int = DEFAULT_TOP_K,
                 chain: int = 1):
        super().__init__(cfg, n_features, replace_lost, top_k, chain)
        self.n_streams = int(n_streams)

    def _coerce(self, batch) -> jax.Array:
        if batch.ndim != 3 or batch.shape[0] != self.n_streams:
            raise KLTError(
                f"({self._name}.feed) expected a "
                f"[{self.n_streams}, H, W] frame batch, got {batch.shape}")
        return batch

    def _start(self, batch) -> None:
        self._pyr, x, y, val, self._aff, ex = _select_batch(
            batch, self.cfg, self.n_features, self.top_k)
        self._state = (x, y, val)
        self._chunks.append((x[:, None], y[:, None], val[:, None]))
        self._exhausted = jnp.any(ex)

    def _advance(self, batches: list) -> None:
        if len(batches) != self.chain and len(batches) > 1:
            # partial chains advance per-tick so each tail length does
            # not compile its own chained program
            for b in batches:
                self._advance([b])
            return
        x, y, val = self._state
        (self._pyr, hist, (x, y, val), self._aff, ex) = _step_batch(
            self._pyr, tuple(batches), x, y, val, self.cfg,
            self.replace_lost, self.top_k, self._aff,
            n_steps=len(batches))
        self._chunks.append(hist)
        self._state = (x, y, val)
        self._note_exhausted(jnp.any(ex))

    def _host_rows(self, c) -> tuple:
        # [B, k, N] device -> [k, B, N] host rows
        return tuple(np.moveaxis(np.asarray(c[j]), 0, 1)
                     for j in range(3))

    def _empty_rows(self) -> tuple:
        b, n = self.n_streams, self.n_features
        return (np.empty((0, b, n), np.float32),
                np.empty((0, b, n), np.float32),
                np.empty((0, b, n), np.int32))


def serve_stream(frames: Iterable, cfg: Optional[TrackerConfig] = None,
                 n_features: int = 150, replace_lost: bool = True,
                 top_k: int = DEFAULT_TOP_K, chain: int = 1,
                 prefetch: int = 0, stage_uint8: bool = False) -> tuple:
    """Track a frame stream end-to-end with h2d/compute overlap.

    The streaming analogue of ``track_sequence_device``: identical math
    and return layout ((x, y, val) stacked numpy), but frames may come
    from any iterable (camera, decoder, ...). h2d overlaps compute via
    JAX's async dispatch; ``prefetch`` > 0 additionally pulls from the
    source in a background staging thread (use when the SOURCE is slow
    — for fast sources the thread contends and measures slower, see
    module notes). ``stage_uint8=True`` ships frames 8-bit (exact for
    uint8 sources — the reference's PGM lineage — and 4x less link
    traffic)."""
    tr = StreamingTracker(cfg, n_features, replace_lost=replace_lost,
                          top_k=top_k, chain=chain)
    stage_dtype = np.uint8 if stage_uint8 else np.float32
    it = (prefetch_to_device(frames, depth=prefetch,
                             stage_dtype=stage_dtype) if prefetch > 0
          # already-device frames pass through untouched: np.asarray on
          # a jax.Array would pull it back to the host
          else (f if isinstance(f, jax.Array)
                else jnp.asarray(np.asarray(f, stage_dtype))
                for f in frames))
    for frame in it:
        tr.feed(frame)
    return tr.table()
