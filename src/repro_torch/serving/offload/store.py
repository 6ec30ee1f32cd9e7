"""Double-buffered asynchronous rollback-checkpoint offload store.

Counterpart of ``repro.serving.offload.store``. The sampler refreshes the
live rollback store every ``interval`` denoising steps, and the only copy
of that store lives on the device. At stream-window boundaries the engine
hands the store the sampler's carry; when a refresh landed in the window
the store snapshots the carry's checkpoint stores into host memory in
tile-contiguous layout (``layout.py``), **overlapped with the next
window's denoising steps**. ``restore()`` re-uploads the last committed
snapshot (restore-on-rollback).

On a CUDA device a commit is three moves:

1. the repack (``layout.stage_leaf``) on the **current** stream: a device
   copy of every leaf. The port refreshes checkpoints *in place*
   (``ExecContext._write_ckpt``) and the window after a commit starts on
   a refresh step, so its first GEMMs overwrite the very buffers being
   offloaded; the staging copy is ordered before them on the stream;
2. a device-to-host copy of the staging tensors on a **side** stream that
   waits for an event recorded after the repack, into one of two pinned
   host sets allocated once and reused by every later commit;
3. an event recorded on the side stream after the copy. The staging
   tensors are held until that event has completed, so the caching
   allocator cannot hand their memory to the main stream while the copy
   still reads it.

Double buffering::

    window k   steps ──────────────►│ window k+1 steps ─────────────►│
                     on_window(carry)│               on_window(carry)│
    back   ◄── repack (main stream), copy (side stream; overlapped)
    front  ◄────────────── swap when the copy's event has completed
    restore() reads front: always the last *completed* snapshot.

At most one copy is in flight: a commit first joins the previous one.
``wait()`` synchronizes the in-flight event and counts ``stats.waits``
when the copy had not completed yet. A failed commit is raised as
``RuntimeError("checkpoint offload commit failed")`` at the next join
point (``wait``, ``begin_batch``, ``finish_batch``, ``restore``), or at
once with ``async_commit=False``, which waits for each copy before
returning. On a CUDA device the store never drops to synchronous or
unpinned copies on its own: a pinned allocation or a stream that fails
raises. On the CPU (the tests) nothing is pinned and every copy is
synchronous.

Trace tap: ``on_event(event, step, wall_elapsed_s, **attrs)`` fires when
a commit settles (at the join that finds its copy complete) and after
each restore, with ``nbytes`` and ``energy_j = nbytes *
energy_per_byte_j`` (the engine arms the per-byte cost from the
perfmodel's DRAM energy). A commit's ``wall_elapsed_s`` is the repack
plus the device-to-host copy as their CUDA events timed them, from the
repack's start to the copy's end; on the CPU it is the host time of the
synchronous copy.

The live store the sampler corrects from is never written by the store,
so offload-enabled and offload-disabled runs give bit-identical latents.
The commit and skip decisions (``_last_refresh_step``, ``_spiking``) are
the reference's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core.rollback import DEFAULT_INTERVAL
from repro_torch.serving.offload import layout as layout_lib


@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    """Knobs for the checkpoint-offload subsystem (engine-level); the
    engine's ``offload=None`` turns offload off."""
    # Systolic-tile shape the host layout is packed in (Sec 5.4; matches
    # the paper accelerator's 32x32 arrays and the ABFT tile granularity).
    tile_m: int = 32
    tile_n: int = 32
    # Tile-contiguous host layout (core.repack). False = row-major host
    # copies -- the Fig 10(b) ablation, charged more DRAM rows on restore.
    repacked: bool = True
    # Copy on a side stream, overlapped with the next window's compute.
    # False = wait for each copy inside the window boundary -- the
    # serialized baseline the planner's stall model prices.
    async_commit: bool = True
    # Defer (skip) a commit when the carry monitor's EMA BER exceeds
    # skip_spike_ratio * target_ber: under a detection storm the
    # activations being snapshotted are the likely-corrupted ones, so the
    # store keeps the last good snapshot instead. None = always commit.
    skip_spike_ratio: Optional[float] = None
    target_ber: float = 3e-3


@dataclasses.dataclass
class OffloadStats:
    """Cumulative store counters (per-batch deltas via ``delta``)."""
    commits: int = 0
    skipped: int = 0            # refresh windows deferred by a BER spike
    restores: int = 0
    bytes_offloaded: int = 0
    waits: int = 0              # joins that actually blocked on a commit

    def snapshot(self) -> "OffloadStats":
        return dataclasses.replace(self)

    def delta(self, since: "OffloadStats") -> "OffloadStats":
        return OffloadStats(
            commits=self.commits - since.commits,
            skipped=self.skipped - since.skipped,
            restores=self.restores - since.restores,
            bytes_offloaded=self.bytes_offloaded - since.bytes_offloaded,
            waits=self.waits - since.waits)


@dataclasses.dataclass
class _Flight:
    """One commit whose device-to-host copy may still be running."""
    step: int
    packed: object                   # tree of PackedLeaf over a host set
    host_set: int                    # which of the two host sets it fills
    nbytes: int
    host_s: float = 0.0              # host time of _start (CPU: the copy)
    staged: Optional[list] = None    # held until the copy has completed
    # CUDA events: repack start/end (current stream), copy start/end
    # (side stream); None on the CPU, where the copy is already done.
    events: Optional[Tuple[torch.cuda.Event, ...]] = None


class OffloadStore:
    """Host-side double buffer for one engine's rollback checkpoints.

    One store serves the whole engine: ``begin_batch`` rebinds it to the
    next micro-batch's refresh interval, ``on_window(done, carry)`` is the
    sampler-boundary tap (``sample_stream(on_carry=...)``), and
    ``finish_batch`` joins any in-flight copy so the batch's accounting is
    settled before results are stamped."""

    def __init__(self, cfg: Optional[OffloadConfig] = None) -> None:
        self.cfg = cfg or OffloadConfig()
        self.stats = OffloadStats()
        self._front = None              # last committed packed snapshot
        self._front_step = -1
        self._front_set = 1             # host set holding the front
        self._flight: Optional[_Flight] = None
        self._exc: Optional[BaseException] = None
        self._interval = DEFAULT_INTERVAL
        self._prev_done = 0
        self._batch_mark = self.stats.snapshot()
        # the two host sets (lists of host tensors in leaf order), made by
        # the first commit and reused while the leaf shapes stay the same
        self._host_sets: List[List[torch.Tensor]] = []
        self._side: Optional[torch.cuda.Stream] = None
        # seconds spent allocating (pinning) the host sets, kept apart
        # from the commits they serve
        self.pinned_alloc_s = 0.0
        # (repack ms, device-to-host copy ms) per settled CUDA commit of
        # the current batch, from CUDA events on the stream each ran on
        self.commit_ms: List[Tuple[float, float]] = []
        # trace tap, fired as on_event(event, step, wall_elapsed_s,
        # **attrs) when a commit settles and after a restore
        self.on_event: Optional[Callable] = None
        # modeled joules per offloaded byte; armed by the engine
        self.energy_per_byte_j = 0.0

    # ------------------------------------------------------------ binding
    def begin_batch(self, interval: int, batch_index: int) -> None:
        """Rebind to one micro-batch run (the engine calls this per
        batch); ``batch_index`` is the reference's signature (the trace
        spans take their batch from the recorder)."""
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.wait()                     # settle the previous batch's copy
        self._interval = int(interval)
        self._prev_done = 0
        self._batch_mark = self.stats.snapshot()
        self.commit_ms = []

    def finish_batch(self) -> OffloadStats:
        """Join the in-flight copy; returns this batch's stat delta."""
        self.wait()
        return self.stats.delta(self._batch_mark)

    # ----------------------------------------------------------- the tap
    def on_window(self, done_steps: int, carry) -> None:
        """Sampler window-boundary hook: commit when a refresh landed.

        ``carry`` is the sampler's carry tuple ``(latents, stores,
        taylor, monitor, corrected, nevals)`` -- the live checkpoint
        stores are ``carry[1]``, the BER monitor ``carry[3]``."""
        start, self._prev_done = self._prev_done, done_steps
        refreshed = (done_steps > start
                     and start <= self._last_refresh_step(done_steps))
        if not refreshed:
            return
        if self._spiking(carry[3]):
            self.stats.skipped += 1
            return
        self.commit(self._last_refresh_step(done_steps), carry[1])

    def _last_refresh_step(self, done_steps: int) -> int:
        """Most recent step < done_steps with step % interval == 0."""
        return ((done_steps - 1) // self._interval) * self._interval

    def _spiking(self, monitor) -> bool:
        ratio = self.cfg.skip_spike_ratio
        if ratio is None:
            return False
        return float(monitor.ema_ber) > ratio * self.cfg.target_ber

    # ------------------------------------------------------------ commits
    def commit(self, step: int, stores) -> None:
        """Offload one snapshot of ``stores``; the copy overlaps the
        caller's next work unless ``async_commit`` is off."""
        self.wait()                     # double buffer: at most 1 in flight
        try:
            t0 = time.perf_counter()
            self._flight = self._start(step, stores)
            self._flight.host_s = time.perf_counter() - t0
        # A failed commit must not leave the engine serving as if the
        # offload were healthy: keep the error for the next join point.
        except Exception as exc:        # noqa: BLE001 -- re-raised by wait
            self._exc = exc
            if self.cfg.async_commit:
                return
        if not self.cfg.async_commit or self._flight.events is None:
            self._join(count=False)     # synchronous: settle (or raise) now

    def _start(self, step: int, stores) -> _Flight:
        cfg = self.cfg
        leaves = layout_lib.tree_leaves(stores)
        dev = leaves[0].device
        cuda = dev.type == "cuda"
        if cuda:
            main = torch.cuda.current_stream(dev)
            if self._side is None:
                self._side = torch.cuda.Stream(device=dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record(main)
        # 1. device copy in host layout, on the current stream
        staged = [layout_lib.stage_leaf(a, cfg.tile_m, cfg.tile_n,
                                        cfg.repacked) for a in leaves]
        if cuda:
            ev[1].record(main)
        back = 1 - self._front_set
        hosts = self._hosts_for(staged)[back]

        def copy_all(non_blocking):
            return [layout_lib.host_leaf(a, s, cfg.tile_m, cfg.tile_n,
                                         cfg.repacked, host=h,
                                         non_blocking=non_blocking)
                    for a, s, h in zip(leaves, staged, hosts)]
        if cuda:
            # 2. device-to-host on the side stream, after the repack
            self._side.wait_event(ev[1])
            with torch.cuda.stream(self._side):
                ev[2].record(self._side)
                packed = copy_all(non_blocking=True)
                ev[3].record(self._side)
        else:
            packed = copy_all(non_blocking=False)
        it = iter(packed)
        tree = layout_lib.tree_map(lambda _: next(it), stores)
        return _Flight(step=step, packed=tree, host_set=back,
                       nbytes=layout_lib.store_nbytes(packed),
                       staged=staged if cuda else None,
                       events=tuple(ev) if cuda else None)

    def _hosts_for(self, staged: List[torch.Tensor]
                   ) -> List[List[torch.Tensor]]:
        """The two host sets for leaves shaped like ``staged``: allocated
        (pinned, on a CUDA device) the first time, reused after."""
        sig = [(tuple(s.shape), s.dtype) for s in staged]
        if [(tuple(h.shape), h.dtype) for h in
                (self._host_sets[0] if self._host_sets else [])] != sig:
            pin = staged[0].is_cuda
            t0 = time.perf_counter()
            sets = [[torch.empty(shape, dtype=dtype, pin_memory=pin)
                     for shape, dtype in sig] for _ in range(2)]
            if pin and not all(h.is_pinned() for s in sets for h in s):
                raise RuntimeError("offload host buffers are not pinned")
            self.pinned_alloc_s += time.perf_counter() - t0
            self._host_sets = sets
        return self._host_sets

    def wait(self) -> None:
        """Join the in-flight commit, if any; re-raises a commit failure
        at this join point."""
        self._join(count=True)

    def _join(self, count: bool) -> None:
        fl, self._flight = self._flight, None
        if fl is not None and self._exc is None:
            try:
                if fl.events is not None:
                    done = fl.events[-1]
                    if count and not done.query():
                        self.stats.waits += 1
                    done.synchronize()
                self._settle(fl)
            except RuntimeError as exc:   # a CUDA error from the copy
                self._exc = exc
        exc, self._exc = self._exc, None
        if exc is not None:
            raise RuntimeError("checkpoint offload commit failed") from exc

    def _settle(self, fl: _Flight) -> None:
        """The completed copy becomes the front (the staging tensors are
        released with ``fl``)."""
        self._front, self._front_step = fl.packed, fl.step
        self._front_set = fl.host_set
        self.stats.commits += 1
        self.stats.bytes_offloaded += fl.nbytes
        wall_s = fl.host_s
        if fl.events is not None:
            e = fl.events
            self.commit_ms.append((e[0].elapsed_time(e[1]),
                                   e[2].elapsed_time(e[3])))
            wall_s = e[0].elapsed_time(e[3]) * 1e-3
        if self.on_event is not None:
            self.on_event("commit", fl.step, wall_s, nbytes=fl.nbytes,
                          energy_j=fl.nbytes * self.energy_per_byte_j,
                          asynchronous=self.cfg.async_commit)

    # ------------------------------------------------------------ queries
    @property
    def committed_step(self) -> int:
        """Denoising step of the last committed snapshot (-1 = none)."""
        return self._front_step

    @property
    def committed_nbytes(self) -> int:
        return (layout_lib.store_nbytes(self._front)
                if self._front is not None else 0)

    def restore(self):
        """Re-upload the last committed snapshot to its device: the leaves
        come back bit-identical to the live store they were snapshotted
        from (pack/unpack is exact), in the store's tree structure."""
        self.wait()
        if self._front is None:
            raise RuntimeError("restore() before any committed snapshot")
        self.stats.restores += 1
        t0 = time.perf_counter()
        nbytes = layout_lib.store_nbytes(self._front)
        out = layout_lib.unpack_store(self._front)
        if self.on_event is not None:
            self.on_event("restore", self._front_step,
                          time.perf_counter() - t0, nbytes=nbytes,
                          energy_j=nbytes * self.energy_per_byte_j)
        return out
