"""Decode worker PROCESSES feeding one device dispatcher.

Port of ``videoquery/pipeline/mpstream.py``. The reference decoded with a
multiprocessing.Pool over videos (build_wof_clips.py:175-184); here each
worker streams compact upload payloads (``pipeline.payload.stream_payloads``:
decode at the target size, cv2 gray, tick crop and YUV, constant memory a
worker) over a bounded queue to the one process that owns the card, which
uploads and runs each batch as it arrives.

Workers are started with ``spawn``: the parent holds a CUDA context, which
a forked child must not inherit. They start without the parent's main
module (the extraction CLI's imports torch), so a worker imports this
module and the payload function's module, which load numpy and cv2 but
neither torch nor jax. A ``WorkerPool`` stays up across calls and is bound to one
configuration, its ``key``; ``extract_videos_mp`` refuses a pool whose key
is not the extractor's. A worker that dies is not replaced: the pool runs
on with the rest, and the video it held fails."""

from __future__ import annotations

import importlib
import logging
import multiprocessing as mp
import os
import queue
import sys
import traceback
import types
from typing import Callable, Sequence

from videoquery_torch.core.config import ExtractionConfig

log = logging.getLogger(__name__)

DEFAULT_PAYLOAD_FN = "videoquery_torch.pipeline.payload:stream_payloads"


def _resolve(spec: str) -> Callable:
    mod, _, name = spec.partition(":")
    return getattr(importlib.import_module(mod), name)


def pool_key(cfg: ExtractionConfig, flow_res_div: int, new_size,
             payload_spec: str = DEFAULT_PAYLOAD_FN) -> tuple:
    """The configuration a pool's workers build payloads for."""
    return (repr(cfg), flow_res_div, tuple(new_size or ()), payload_spec)


def _worker(task_q, out_q, cfg: ExtractionConfig, flow_res_div: int,
            new_size, payload_spec: str) -> None:
    """Decode worker: pull (call_id, vi, path) tasks and stream payloads to
    the dispatcher until the None sentinel. Top-level, so spawn can pickle
    it."""
    payload_fn = _resolve(payload_spec)
    pid = os.getpid()
    while True:
        item = task_q.get()
        if item is None:
            return
        call_id, vi, path = item
        # claim first: if this process dies mid-video (a cv2 segfault), the
        # dispatcher knows WHICH video to fail instead of waiting forever
        out_q.put((call_id, "start", vi, pid))
        try:
            for payload in payload_fn(path, cfg, flow_res_div, new_size):
                out_q.put((call_id, "payload", vi, payload))
            out_q.put((call_id, "done", vi, None))
        except Exception:  # noqa: BLE001 — reported per video, the worker goes on
            out_q.put((call_id, "error", vi,
                       f"{path}: {traceback.format_exc()}"))


class WorkerPool:
    """A decode-worker fleet that lives across extract calls, bound to one
    (cfg, flow_res_div, new_size, payload function) configuration."""

    def __init__(self, workers: int, cfg: ExtractionConfig,
                 flow_res_div: int, new_size,
                 payload_spec: str = DEFAULT_PAYLOAD_FN,
                 queue_window: int = 4):
        self.workers = workers
        self.key = pool_key(cfg, flow_res_div, new_size, payload_spec)
        ctx = mp.get_context("spawn")
        self.task_q = ctx.Queue()
        # bounded: backpressure a fast decode fleet against a slow device
        self.out_q = ctx.Queue(maxsize=max(2, queue_window))
        self.procs = [
            ctx.Process(target=_worker,
                        args=(self.task_q, self.out_q, cfg, flow_res_div,
                              new_size, payload_spec),
                        daemon=True)
            for _ in range(workers)
        ]
        # spawn re-runs the parent's __main__ in each child (by its module
        # name under `python -m`), and the extraction CLI's main imports
        # torch: the children start from a bare main instead, so a worker
        # imports only what unpickling _worker and the payload function need
        main = sys.modules["__main__"]
        sys.modules["__main__"] = types.ModuleType("__main__")
        try:
            for p in self.procs:
                p.start()
        finally:
            sys.modules["__main__"] = main
        self._call_id = 0

    def alive(self) -> bool:
        return any(p.is_alive() for p in self.procs)

    def next_call(self) -> int:
        self._call_id += 1
        return self._call_id

    def shutdown(self, timeout: float = 30.0) -> None:
        for _ in self.procs:
            self.task_q.put(None)
        for p in self.procs:
            p.join(timeout=timeout)
            if p.is_alive():
                p.terminate()
                p.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


def stream_dispatch(pool: WorkerPool, paths: Sequence[str],
                    dispatch: Callable) -> tuple[dict, list]:
    """Feed paths to the pool, apply `dispatch` to every payload in arrival
    order, return ({vi: [dispatch results]}, errors). A worker that dies
    without reporting (a segfault or an OOM kill in cv2) is found by
    polling liveness, and its unfinished video fails instead of hanging the
    caller."""
    call_id = pool.next_call()
    for vi, path in enumerate(paths):
        pool.task_q.put((call_id, vi, path))
    results: dict[int, list] = {i: [] for i in range(len(paths))}
    done: set[int] = set()
    claimed: dict[int, int] = {}  # vi -> worker pid
    errors: list[str] = []

    def fail(vi, why):
        done.add(vi)
        errors.append(f"{paths[vi]}: {why}")
        log.error("extraction worker died mid-video: %s (%s)", paths[vi], why)

    def handle(msg_call, kind, vi, obj):
        if msg_call != call_id:
            return  # straggler from an abandoned earlier call
        if kind == "start":
            claimed[vi] = obj
        elif kind == "payload":
            results[vi].append(dispatch(obj))
        elif kind == "done":
            done.add(vi)
        else:  # error
            done.add(vi)
            errors.append(obj)
            log.error("extraction worker failed: %s", obj)

    while len(done) < len(paths):
        try:
            handle(*pool.out_q.get(timeout=5.0))
            continue
        except queue.Empty:
            pass
        # a worker that exited without 'done'-ing its claimed video died
        # silently; drain stragglers first so a 'done' racing the exit is
        # not miscounted as a death
        try:
            while True:
                handle(*pool.out_q.get_nowait())
        except queue.Empty:
            pass
        dead = {p.pid for p in pool.procs if p.exitcode is not None}
        for vi, pid in list(claimed.items()):
            if vi not in done and pid in dead:
                fail(vi, f"decode worker died without reporting (pid {pid})")
        if pool.alive():
            continue  # live workers will pick up any unclaimed tasks
        for vi in range(len(paths)):
            if vi not in done:
                fail(vi, "no live decode workers left (exitcodes: "
                         f"{[p.exitcode for p in pool.procs]})")
    return results, errors


def extract_videos_mp(extractor, paths: Sequence[str], workers: int = 0,
                      new_size=None, window_batches: int = 4,
                      pool: WorkerPool | None = None):
    """Signatures of many videos with decode worker processes:
    {path: [ClipSignatures]}, each video's batches sorted by clip and
    downloaded in one copy. Raises RuntimeError listing every failed video
    after the rest completed. A passed pool is reused and left running; it
    must have been started for this extractor's configuration, else
    ValueError. Without one, a fleet is spawned for the call and shut
    down."""
    from videoquery_torch.pipeline.extract import gather_signatures

    if new_size is None:
        new_size = extractor._decode_size()
    own_pool = pool is None
    if own_pool:
        if workers <= 0:
            workers = min(len(paths), max(1, (os.cpu_count() or 1) - 1))
        workers = max(1, min(workers, len(paths)))
        pool = WorkerPool(workers, extractor.cfg, extractor.flow_res_div,
                          new_size, queue_window=window_batches)
    else:
        want = pool_key(extractor.cfg, extractor.flow_res_div, new_size)
        if pool.key != want:
            raise ValueError(f"the worker pool builds payloads for {pool.key!r}, "
                             f"but this extractor needs {want!r}")
    try:
        sigs, errors = stream_dispatch(pool, paths, extractor._dispatch_payload)
    finally:
        if own_pool:
            pool.shutdown()
    if errors:
        raise RuntimeError(
            f"{len(errors)}/{len(paths)} videos failed:\n" + "\n".join(errors))
    return {path: gather_signatures(sorted(sigs[vi], key=lambda s: s.clip_numbers[0]))
            for vi, path in enumerate(paths)}
