"""Decode bursts as CUDA graphs (the port's counterpart of the JAX
engine compiling ``decode_burst`` once per span).

:class:`BurstRunner` owns one engine's bursts.  On the card it captures
:func:`model_runner.decode_burst` into a ``torch.cuda.CUDAGraph`` once
per ``(span, sample mode)``, lazily at first use, all graphs sharing one
memory pool and static input buffers (``ctl_i``, ``ctl_f``, the page
tables); the KV pool and the penalty count tables are the engine's own
tensors, updated in place by every replay.  A replay launches every
kernel of ``span`` decode + sample steps with one host call, where the
eager loop pays each operator's launch on the host.  Off the card the
runner calls ``decode_burst`` eagerly (the path the tests hold against
the JAX package).

A capture first runs the burst eagerly twice on a side stream with every
row inactive (writes go to the trash page, the count bumps add 0), so
the kernels' builds, their first launches (cluster and shared-memory
attributes, occupancy queries) and the GEMM's split counters exist
before capture; then
it captures with the same inert controls.  A capture that fails raises:
nothing on the card falls back to the eager loop.

The page tables are a static input refilled before every replay, so a
sliding-window model's tables, whose entries below each row's window
turn into trash placeholders as its pages are trimmed between replays,
need no graph of their own: the key stays ``(span, mode)``, and the
graphs are captured at the engine's ``max_batch_size`` rows.

Launch counts: a capture launches nothing, so the counts its wrappers
add are taken back, and each replay adds them again
(:func:`ops.dispatch.count_launches`), one per kernel launch the graph
makes.

Dispatch-ahead: :meth:`BurstRunner.launch` replays, enqueues the copy of
``sampled`` into pinned host memory and records an event, and returns at
once; :meth:`BurstHandle.tokens` waits on that event.  The engine may
dispatch the successor burst (from the device-side ``next_ctl`` carry)
before it waits: the stream's order keeps the successor's replay from
overwriting the tokens before they are copied.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from fusioninfer_tpu_torch.engine.model_runner import (
    CTL_F_COLS,
    CTL_I_COLS,
    decode_burst,
)
from fusioninfer_tpu_torch.ops import dispatch

logger = logging.getLogger("fusioninfer.torch.graphs")


@dataclass
class BurstHandle:
    """One dispatched burst: ``sampled`` [span, B] int64 (pinned host
    memory being filled on the card, the eager result off it),
    ``next_ctl`` [B, 8] int32 and ``ctl_f`` [B, 6] f32 on the device (the
    successor's controls), ``event`` recorded after the copy (None off
    the card)."""

    sampled: torch.Tensor
    next_ctl: torch.Tensor
    ctl_f: torch.Tensor
    event: Optional["torch.cuda.Event"] = None

    def tokens(self) -> np.ndarray:
        """The burst's tokens on the host, ``[span, B]``; blocks until
        the burst and its copy have run."""
        if self.event is not None:
            self.event.synchronize()
        return self.sampled.numpy()


@dataclass
class Capture:
    span: int
    mode: str
    seconds: float  # warm-up and capture, on the host's clock
    pool_bytes: int  # device memory the graph's capture reserved


class BurstRunner:
    def __init__(self, engine):
        """``engine``: the :class:`engine.NativeEngine` whose model,
        pool, count tables, batch size and walk settings the bursts use
        (read once; the tensors are updated in place, never replaced)."""
        self.cfg, self.cache_cfg = engine.cfg, engine.cache_cfg
        self.params, self.cache = engine.params, engine.cache
        self.counts = (engine._token_counts, engine._output_counts, engine._suppress)
        self.kv_splits, self.cluster = engine.kv_splits, engine.walk_cluster
        self.device = engine.device
        self.graphed = self.device.type == "cuda"
        B, mp = engine.max_batch_size, self.cache_cfg.max_pages_per_seq
        self.ctl_i = torch.zeros((B, len(CTL_I_COLS)), dtype=torch.int32, device=self.device)
        self.ctl_f = torch.zeros((B, len(CTL_F_COLS)), dtype=torch.float32,
                                 device=self.device)
        self.tables = torch.zeros((B, mp), dtype=torch.int32, device=self.device)
        # (span, mode) -> (graph, sampled, next_ctl, launches per replay)
        self._graphs: dict = {}
        self._pool = None
        self.captures: list[Capture] = []

    def _burst(self, ctl_i, ctl_f, tables, span: int, mode: str):
        return decode_burst(self.cfg, self.cache_cfg, self.params, self.cache, ctl_i,
                            ctl_f, *self.counts, tables, n_steps=span,
                            sample_mode=mode, kv_splits=self.kv_splits,
                            cluster=self.cluster)

    def launch(self, ctl_i, ctl_f, tables, span: int, mode: str) -> BurstHandle:
        """Dispatch one burst of ``span`` steps.  ``ctl_i`` / ``ctl_f`` /
        ``tables``: numpy arrays from the host, or (``ctl_i``, ``ctl_f``)
        device tensors carried from an earlier burst's handle."""
        if not self.graphed:
            ctl_i_t, ctl_f_t, tables_t = (
                torch.as_tensor(x, device=self.device) for x in (ctl_i, ctl_f, tables))
            sampled, next_ctl = self._burst(ctl_i_t, ctl_f_t, tables_t, span, mode)
            return BurstHandle(sampled, next_ctl, ctl_f_t)
        graph, sampled, next_ctl, per_replay = self._graph(span, mode)
        for static, src in ((self.ctl_i, ctl_i), (self.ctl_f, ctl_f),
                            (self.tables, tables)):
            _fill(static, src)
        graph.replay()
        dispatch.count_launches(per_replay)
        host = torch.empty(sampled.shape, dtype=sampled.dtype, pin_memory=True)
        host.copy_(sampled, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return BurstHandle(host, next_ctl, self.ctl_f, event)

    def _graph(self, span: int, mode: str):
        key = (span, mode)
        if key not in self._graphs:
            self._graphs[key] = self._capture(span, mode)
        return self._graphs[key]

    def _capture(self, span: int, mode: str):
        t0 = time.perf_counter()
        # inert controls: every row inactive (trash-page writes, +0 count
        # bumps), so neither the warm-up nor the capture changes state
        self.ctl_i.zero_()
        self.ctl_f.zero_()
        self.tables.fill_(self.cache_cfg.trash_page)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._burst(self.ctl_i, self.ctl_f, self.tables, span, mode)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        # the capture releases the allocator's cached blocks first; what it
        # reserves beyond that is the graph's share of the pool
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = dispatch.launches(by_shape=True)
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                sampled, next_ctl = self._burst(self.ctl_i, self.ctl_f, self.tables,
                                                span, mode)
        finally:
            after = dispatch.launches(by_shape=True)
            dispatch.restore_launches(before)
        torch.cuda.synchronize(self.device)
        per_replay = {k: n - before.get(k, 0) for k, n in after.items()
                      if n != before.get(k, 0)}
        cap = Capture(span, mode, time.perf_counter() - t0,
                      torch.cuda.memory_reserved(self.device) - reserved0)
        self.captures.append(cap)
        logger.info("captured the %s decode burst of span %d in %.2f s "
                    "(pool +%d bytes, %d kernel launches a replay)", mode, span,
                    cap.seconds, cap.pool_bytes,
                    sum(n for k, n in per_replay.items() if k in dispatch.KERNELS))
        return graph, sampled, next_ctl, per_replay


def _fill(static: torch.Tensor, src) -> None:
    """Copy ``src`` into a static buffer in stream order: a device tensor
    directly, a host array through pinned memory (a pageable upload
    would wait for the stream to drain and undo the dispatch-ahead)."""
    if isinstance(src, torch.Tensor):
        if src is not static:
            static.copy_(src, non_blocking=True)
        return
    host = torch.from_numpy(np.ascontiguousarray(src)).to(static.dtype).pin_memory()
    static.copy_(host, non_blocking=True)
