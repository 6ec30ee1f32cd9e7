"""Asynchronous rollback-checkpoint offload for the serving stack.

Counterpart of ``repro.serving.offload`` (Sec 5.4: offloading intervals
and tile-contiguous data layouts reduce the checkpoint store's memory
overhead):

===============  ======================================================
module           role
===============  ======================================================
``store``        double-buffered host-side checkpoint store: at stream-
                 window boundaries, repacks the live stores on the
                 device and copies them into reused pinned host buffers
                 on a side CUDA stream, overlapped with the next window;
                 ``restore()`` re-uploads the last committed snapshot
``layout``       routes snapshots through ``core.repack`` tile-contiguous
                 layouts and charges partial-tile recovery the
                 ``perfmodel.dram`` repacked row count
``planner``      per-(arch, op, steps, bucket) refresh-interval
                 optimizer: minimizes modeled refresh energy + residual
                 stall + detection-rate-weighted staleness penalty;
                 resolves ``rollback_interval="auto"`` requests through
                 ``DriftServeEngine.auto_rollback_interval``
===============  ======================================================

Wiring: ``DriftServeEngine(offload=OffloadConfig())`` (the CLI's
``--offload``) runs every monitored-mode batch through the windowed
sampler with the refresh interval as the window, committing between
windows via ``sample_stream(on_carry=...)``; the engine's virtual clock
charges the planner's residual stall. Finals are bit-identical with
offload on or off.
"""
from repro_torch.serving.offload.layout import (PackedLeaf, layout_report,
                                                pack_leaf, pack_store,
                                                recovery_rows, store_nbytes,
                                                unpack_leaf, unpack_store)
from repro_torch.serving.offload.planner import (IntervalPlan,
                                                 OffloadPlanner,
                                                 pareto_frontier)
from repro_torch.serving.offload.store import (OffloadConfig, OffloadStats,
                                               OffloadStore)

__all__ = [
    "OffloadConfig", "OffloadStats", "OffloadStore",
    "OffloadPlanner", "IntervalPlan", "pareto_frontier",
    "PackedLeaf", "pack_leaf", "unpack_leaf", "pack_store", "unpack_store",
    "store_nbytes", "recovery_rows", "layout_report",
]
