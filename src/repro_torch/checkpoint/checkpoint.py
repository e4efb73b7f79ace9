"""Checkpoint save/restore through TAM collective I/O (port of
``repro.checkpoint.checkpoint``).

Layout: the train state tree (nested dicts and lists of tensors) is
serialized into one contiguous byte space ("the file"): leaves in the
reference's tree order (``_tree``: dicts by sorted key, lists by index,
``None`` skipped), each leaf padded to 256-B alignment. A manifest
(JSON) records leaf paths (``keystr`` strings), dtypes (numpy's names:
``float32``, ``bfloat16``, ``int32``), shapes and offsets. Each simulated
host contributes its span of every leaf as (offset, length, payload)
requests, exactly an MPI collective write with an MPI file view, and
:class:`HostCollectiveIO` executes it with the TAM or two-phase schedule.
For the same state the manifest and the segment files equal the
reference's byte for byte, so a checkpoint written by either package
restores in the other.

Requests and payloads are tensors on the leaves' device (payload bytes
are views of each leaf as uint8); the writer moves them to its own.
Restore is the write's mirror: the reader's per-rank read requests route
through the planner (``HostCollectiveIO.read``: ``compile_plan`` with
``direction="read"``, the node-level window cache, ranged segment
reads); each leaf comes back as a tensor on the device of the matching
leaf of ``like_tree``. ``subset=`` restores part of the
tree from exactly its byte ranges; the legacy single-reader reassembly
(``planned=False``) is the byte-identity oracle.

Async saves (``save_checkpoint(..., async_=True)`` /
:meth:`CheckpointManager.save_async`) snapshot the tree to host memory
synchronously (so a training step that replaces or mutates the
parameters afterwards never changes the written bytes), return a
:class:`PendingCheckpoint` future, and drain the collective write on a
daemon thread through the same path as a sync save. Crash consistency
is commit-last: a stale manifest for the target path is unlinked BEFORE
the segments are touched and the new manifest is written only after
every segment landed, so a torn write is never restorable — restart
discovery (:meth:`CheckpointManager.latest_step`,
``runtime.elastic.find_restart_step``) sees committed manifests only.
"""
from __future__ import annotations

import json
import threading
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from repro_torch._tree import leaves_with_paths, tree_map, unflatten
from repro_torch.checkpoint.host_io import _UNSET, HostCollectiveIO, IOTimings
from repro_torch.core.plan import IOConfig

ALIGN = 256


def _leaf_paths(tree):
    """``(keystr path, leaf)`` in the reference's order."""
    return leaves_with_paths(tree)


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch type (the manifest's ``dtype``)."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"manifest dtype {name!r} has no torch type")
    return dt


def _leaf_bytes(leaf) -> torch.Tensor:
    """The leaf's bytes, flat uint8 (a view where the leaf is
    contiguous)."""
    return leaf.detach().contiguous().reshape(-1).view(torch.uint8)


def build_manifest(tree, step: int = 0) -> dict:
    entries = []
    offset = 0
    for path, t in _leaf_paths(tree):
        nbytes = t.numel() * t.element_size() if t.dim() \
            else t.element_size()
        entries.append({"path": path, "shape": list(t.shape),
                        "dtype": dtype_name(t.dtype), "offset": offset,
                        "nbytes": int(nbytes)})
        offset += -(-nbytes // ALIGN) * ALIGN
    return {"step": step, "file_len": offset, "leaves": entries}


def _leaf_spans(nbytes: int, n_ranks: int):
    """Contiguous per-rank byte spans of one leaf — the SAME sharding
    for save and restore, so a restore's read requests mirror the
    write's exactly (yields (rank, lo, hi), empty spans skipped)."""
    chunk = max(nbytes // n_ranks, 1)
    for r in range(n_ranks):
        lo = min(r * chunk, nbytes)
        hi = nbytes if r == n_ranks - 1 else min((r + 1) * chunk, nbytes)
        if hi > lo:
            yield r, lo, hi


def _rank_requests(tree, manifest, n_ranks: int):
    """Each rank's contiguous span of every leaf -> per-rank
    ``(offsets, lengths, payload)``, offset-sorted: int64 and uint8
    tensors on the leaves' device. The payloads are consecutive slices
    of one stream (the writer takes them without another copy)."""
    reqs = [([], [], []) for _ in range(n_ranks)]
    dev = torch.device("cpu")
    for entry, (path, leaf) in zip(manifest["leaves"], _leaf_paths(tree)):
        flat = _leaf_bytes(leaf)
        dev = flat.device
        for r, lo, hi in _leaf_spans(flat.numel(), n_ranks):
            reqs[r][0].append(entry["offset"] + lo)
            reqs[r][1].append(hi - lo)
            reqs[r][2].append(flat[lo:hi])
    offs, lens, pieces = [], [], []
    for o, ln, d in reqs:
        oo = np.asarray(o, np.int64)
        order = np.argsort(oo, kind="stable")
        offs.append(oo[order])
        lens.append(np.asarray(ln, np.int64)[order])
        pieces += [d[i] for i in order]
    stream = torch.cat(pieces) if pieces \
        else torch.zeros(0, dtype=torch.uint8, device=dev)
    payloads = torch.split(stream, [int(ln.sum()) for ln in lens])
    return [(torch.from_numpy(o).to(dev), torch.from_numpy(ln).to(dev), d)
            for o, ln, d in zip(offs, lens, payloads)]


def snapshot_tree(tree):
    """Copy every leaf of ``tree`` into fresh host (CPU) tensors — the
    snapshot an async save isolates itself with: a training step that
    mutates or replaces the live tensors after
    ``save_checkpoint(async_=True)`` returns can never change the bytes
    the background drain writes."""
    return tree_map(lambda leaf: leaf.detach().to("cpu", copy=True), tree)


class PendingCheckpoint:
    """Future for an in-flight async checkpoint write.

    Returned immediately by ``save_checkpoint(..., async_=True)`` /
    :meth:`CheckpointManager.save_async` after the tree snapshot; the
    collective write drains on a daemon thread. At most one checkpoint
    is in flight per :class:`CheckpointManager`.

    * :meth:`wait` / :meth:`result` block until the drain finishes and
      return ``(manifest, timings)``; a failed drain re-raises the
      background exception (every call).
    * :meth:`block_until_done` is :meth:`wait` returning ``None``.
    * :meth:`done` polls without blocking.

    ``timings`` carry ``snapshot_seconds`` (the host copy the caller
    blocked on), ``drain_wall_seconds`` (the background write) and
    ``overlap_hidden_seconds`` / ``hidden_fraction`` (the part of the
    drain that ran before the caller first blocked on the future).
    """

    def __init__(self, path: Path, step: int, snapshot_seconds: float):
        self.path = Path(path)
        self.step = step
        self.snapshot_seconds = snapshot_seconds
        self._started = time.perf_counter()
        self._finished = None          # perf_counter at drain completion
        self._event = threading.Event()
        self._result = None            # (manifest, timings) on success
        self._exc = None
        self.exception_observed = False  # a wait() already re-raised it

    # -- worker side ---------------------------------------------------
    def _finish(self, manifest: dict, timings: IOTimings) -> None:
        self._finished = time.perf_counter()
        timings.snapshot_seconds = self.snapshot_seconds
        timings.drain_wall_seconds = self._finished - self._started
        self._result = (manifest, timings)
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._finished = time.perf_counter()
        self._exc = exc
        self._event.set()

    # -- caller side ---------------------------------------------------
    def done(self) -> bool:
        """True once the background drain finished (committed OR
        failed) — never blocks."""
        return self._event.is_set()

    def wait(self, timeout: float | None = None):
        """Block until the drain finishes; return ``(manifest,
        timings)``. Raises the background exception if the write failed
        (no manifest was committed) and :class:`TimeoutError` if
        ``timeout`` expires first. The first wait fixes the overlap
        accounting."""
        blocked_at = time.perf_counter()
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"checkpoint {self.path} still draining after {timeout}s")
        if self._exc is not None:
            self.exception_observed = True
            raise self._exc
        manifest, timings = self._result
        if timings.overlap_hidden_seconds == 0.0:
            hidden = min(self._finished, blocked_at) - self._started
            timings.overlap_hidden_seconds = max(
                min(hidden, timings.drain_wall_seconds), 0.0)
        return manifest, timings

    def result(self, timeout: float | None = None):
        """Alias of :meth:`wait` (``concurrent.futures`` spelling)."""
        return self.wait(timeout)

    def block_until_done(self, timeout: float | None = None) -> None:
        """:meth:`wait`, discarding the result — the bare barrier."""
        self.wait(timeout)


def _commit_write(tree, path: Path, io: HostCollectiveIO, step: int,
                  write_kwargs: dict) -> tuple[dict, IOTimings]:
    """The commit-last write body shared by the sync and async paths:
    un-commit first, drain the segments, then write the manifest as the
    atomic commit point."""
    manifest = build_manifest(tree, step)
    mpath = path.parent / (path.name + ".manifest.json")
    if mpath.exists():
        mpath.unlink()
    reqs = _rank_requests(tree, manifest, io.n_ranks)
    timings = io.write(reqs, str(path), **write_kwargs)
    del reqs
    manifest["stripe_size"] = io.stripe_size
    manifest["stripe_count"] = io.stripe_count
    mpath.write_text(json.dumps(manifest))
    return manifest, timings


def save_checkpoint(tree, path: str | Path, *, step: int = 0,
                    io: HostCollectiveIO | None = None,
                    method: str = "tam",
                    local_aggregators: int | None = None,
                    cb_bytes: int | str | None = _UNSET,
                    pipeline: bool = _UNSET,
                    pipeline_depth: int | str | None = _UNSET,
                    slow_hop_codec: str | None = _UNSET,
                    placement=_UNSET,
                    session=None,
                    config: IOConfig | None = None,
                    kernel_fusion: str | None = _UNSET,
                    faults=None, heartbeat=None,
                    async_: bool = False, on_commit=None):
    """Serialize ``tree`` to ``<path>.seg*`` through the collective
    writer, manifest (``<path>.manifest.json``) committed LAST.

    The arguments are the reference's: ``io`` (the writer; a default
    8-rank / 2-node writer on the card is built when omitted), ``method``
    (``"tam"`` | ``"twophase"`` | ``"auto"``), ``local_aggregators``,
    ``config`` (one :class:`IOConfig`, byte units; the bare per-knob
    kwargs without it are deprecated), ``session`` (plan reuse and
    measured feedback, async drains included), ``faults`` /
    ``heartbeat`` (fault injection and failure detection, passed to
    :meth:`HostCollectiveIO.write`), ``async_`` (snapshot to host now,
    return a :class:`PendingCheckpoint`, drain on a daemon thread) and
    ``on_commit`` (called right after the manifest commit; on the drain
    thread when async).

    Returns ``(manifest, timings)``, or a :class:`PendingCheckpoint`
    when ``async_=True``. Raises what the collective write raises —
    from this call when sync, from the future's ``wait()`` when async.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    io = io or HostCollectiveIO(n_ranks=8, n_nodes=2, stripe_size=1 << 20,
                                stripe_count=4)
    write_kwargs = dict(
        method=method, local_aggregators=local_aggregators,
        config=config, cb_bytes=cb_bytes, pipeline=pipeline,
        pipeline_depth=pipeline_depth, slow_hop_codec=slow_hop_codec,
        placement=placement, kernel_fusion=kernel_fusion,
        session=session, faults=faults, heartbeat=heartbeat)
    if not async_:
        manifest, timings = _commit_write(tree, path, io, step,
                                          write_kwargs)
        if on_commit is not None:
            on_commit()
        return manifest, timings
    t0 = time.perf_counter()
    snap = snapshot_tree(tree)
    pending = PendingCheckpoint(path, step,
                                snapshot_seconds=time.perf_counter() - t0)

    def _drain():
        try:
            manifest, timings = _commit_write(snap, path, io, step,
                                              write_kwargs)
            if on_commit is not None:
                on_commit()
            pending._finish(manifest, timings)
        except BaseException as exc:  # surfaced via wait()/result()
            pending._fail(exc)

    threading.Thread(target=_drain, daemon=True,
                     name=f"ckpt-drain-{step}").start()
    return pending


def manifest_fingerprint(manifest: dict) -> int:
    """Deterministic content key of a manifest (CRC of its canonical
    JSON) — what keys a read session entry to THIS checkpoint's
    layout."""
    return zlib.crc32(json.dumps(manifest, sort_keys=True).encode())


def _select_leaves(manifest: dict, subset):
    """Indices of the manifest leaves a ``subset`` keeps: ``None`` =
    all, an iterable of leaf-path strings, or a predicate on the path.
    Unknown paths in an iterable subset are an error."""
    if subset is None:
        return list(range(len(manifest["leaves"])))
    if callable(subset):
        return [i for i, e in enumerate(manifest["leaves"])
                if subset(e["path"])]
    want = set(subset)
    known = {e["path"] for e in manifest["leaves"]}
    missing = want - known
    if missing:
        raise KeyError(f"subset names unknown leaves: {sorted(missing)}; "
                       f"manifest has {sorted(known)}")
    return [i for i, e in enumerate(manifest["leaves"])
            if e["path"] in want]


def restore_checkpoint(path: str | Path, like_tree, *, subset=None, io: HostCollectiveIO | None = None,
                       method: str = "twophase",
                       cb_bytes: int | str | None = _UNSET,
                       pipeline: bool = _UNSET,
                       pipeline_depth: int | str | None = _UNSET,
                       slow_hop_codec: str | None = _UNSET,
                       placement=_UNSET,
                       kernel_fusion: str | None = _UNSET,
                       session=None, config: IOConfig | None = None,
                       node_cache: bool = True, planned: bool | None = None,
                       with_timings: bool = False):
    """Rebuild the tree of ``like_tree``'s structure from the checkpoint
    at ``path``. Each restored leaf is a tensor on the device of the
    matching leaf of ``like_tree`` (the reader's device when that leaf
    is not a tensor): a like tree on another card, or on the CPU, takes
    the state there.

    ``subset`` (leaf-path strings or a predicate on the path) restores
    part of the tree from exactly its byte ranges; the other leaves pass
    through from ``like_tree`` untouched. ``planned`` routes the read
    through :meth:`HostCollectiveIO.read` (default: when an ``io`` is
    given, its ranks and nodes being the reader topology); otherwise the
    legacy single-reader reassembly. Returns ``(tree, step)``, or
    ``(tree, step, timings)`` with ``with_timings=True`` (timings is
    None on the legacy path)."""
    path = Path(path)
    manifest = json.loads(
        (path.parent / (path.name + ".manifest.json")).read_text())
    selected = set(_select_leaves(manifest, subset))
    if planned is None:
        planned = io is not None
    flat = [leaf for _, leaf in _leaf_paths(like_tree)]
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(
            f"like_tree has {len(flat)} leaves but the manifest has "
            f"{len(manifest['leaves'])} — restore needs the saved shape")
    if io is None:   # a reader on the like tree's device, else the card
        dev = next((x.device for x in flat if isinstance(x, torch.Tensor)),
                   None)
        io = HostCollectiveIO(n_ranks=1, n_nodes=1,
                              stripe_size=manifest["stripe_size"],
                              stripe_count=manifest["stripe_count"],
                              device=dev)
    timings = None
    bufs: dict[int, torch.Tensor] = {}
    if planned:
        reqs = [([], []) for _ in range(io.n_ranks)]
        fills = []                 # (rank, pos in rank payload, leaf, lo)
        cursor = [0] * io.n_ranks
        for li in sorted(selected):
            entry = manifest["leaves"][li]
            for r, lo, hi in _leaf_spans(entry["nbytes"], io.n_ranks):
                reqs[r][0].append(entry["offset"] + lo)
                reqs[r][1].append(hi - lo)
                fills.append((r, cursor[r], li, lo, hi))
                cursor[r] += hi - lo
        rank_requests = [(np.asarray(o, np.int64), np.asarray(ln, np.int64))
                         for o, ln in reqs]
        outs, timings = io.read(
            rank_requests, str(path), method=method, config=config,
            cb_bytes=cb_bytes, pipeline=pipeline,
            pipeline_depth=pipeline_depth, slow_hop_codec=slow_hop_codec,
            placement=placement, kernel_fusion=kernel_fusion,
            session=session, node_cache=node_cache,
            fingerprint=manifest_fingerprint(manifest))
        for li in sorted(selected):
            bufs[li] = torch.zeros(manifest["leaves"][li]["nbytes"],
                                   dtype=torch.uint8, device=io.device)
        for r, pos, li, lo, hi in fills:
            bufs[li][lo:hi] = outs[r][pos:pos + hi - lo]
        del outs
    else:
        for li in sorted(selected):
            entry = manifest["leaves"][li]
            bufs[li] = io.read_file(str(path), manifest["file_len"],
                                    offset=entry["offset"],
                                    nbytes=entry["nbytes"])
    new_leaves = []
    for li, (entry, like) in enumerate(zip(manifest["leaves"], flat)):
        if li not in selected:
            new_leaves.append(like)
            continue
        t = bufs.pop(li).view(torch_dtype(entry["dtype"])) \
            .reshape(entry["shape"])
        new_leaves.append(t.to(like.device) if isinstance(like, torch.Tensor)
                          else t)
    tree = unflatten(like_tree, new_leaves)
    if with_timings:
        return tree, manifest["step"], timings
    return tree, manifest["step"]


@dataclass
class CheckpointManager:
    """Rolling checkpoints + restart discovery.

    Holds the cross-save state a checkpoint loop needs: the writer
    topology (``io``), the unified knob surface (``config``), the
    persistent ``session``, the ``heartbeat`` failure detector and the
    rolling-GC window (``keep``). :meth:`save` blocks on the collective
    write; :meth:`save_async` snapshots and returns a
    :class:`PendingCheckpoint`, with at most ONE write in flight (the
    next save first drains the previous future). :meth:`latest_step`
    sees committed manifests only.
    """

    directory: str | Path
    io: HostCollectiveIO
    method: str = "tam"
    local_aggregators: int | None = None
    config: IOConfig | None = None  # the unified knob surface
    cb_bytes: int | str | None = _UNSET   # DEPRECATED shim — use config
    pipeline: bool = _UNSET        # DEPRECATED shim — use config
    pipeline_depth: int | str | None = _UNSET  # DEPRECATED shim
    slow_hop_codec: str | None = _UNSET  # DEPRECATED shim
    placement: str | tuple | None = _UNSET  # DEPRECATED shim
    kernel_fusion: str | None = _UNSET  # DEPRECATED shim
    session: object | None = None  # IOSession: plan reuse across saves
    heartbeat: object | None = None  # HeartbeatMonitor every save
    # consults when a fault spec injects a dead aggregator
    keep: int = 3
    #: the in-flight async save (at most one; see :meth:`save_async`)
    pending: PendingCheckpoint | None = field(default=None, repr=False)

    def _save_kwargs(self, faults) -> dict:
        return dict(
            io=self.io, method=self.method,
            local_aggregators=self.local_aggregators,
            config=self.config, cb_bytes=self.cb_bytes,
            pipeline=self.pipeline, pipeline_depth=self.pipeline_depth,
            slow_hop_codec=self.slow_hop_codec,
            placement=self.placement, kernel_fusion=self.kernel_fusion,
            session=self.session, faults=faults,
            heartbeat=self.heartbeat)

    def save(self, tree, step: int, faults=None) -> IOTimings:
        """One rolling save, blocking until committed; ``faults``
        injects this save's degraded scenario. Any in-flight async save
        drains first (steps commit in save order)."""
        self.block_until_done()
        d = Path(self.directory)
        d.mkdir(parents=True, exist_ok=True)
        _, t = save_checkpoint(
            tree, d / f"ckpt_{step:08d}", step=step,
            **self._save_kwargs(faults))
        self._gc()
        return t

    def save_async(self, tree, step: int, faults=None
                   ) -> PendingCheckpoint:
        """Start an async rolling save and return its future without
        blocking on the collective write (only on the snapshot). If a
        previous async save is still draining, this call blocks until
        it commits, and re-raises its failure if it died unobserved.
        Rolling GC runs on the drain thread after the commit."""
        self.block_until_done()
        d = Path(self.directory)
        d.mkdir(parents=True, exist_ok=True)
        self.pending = save_checkpoint(
            tree, d / f"ckpt_{step:08d}", step=step, async_=True,
            on_commit=self._gc, **self._save_kwargs(faults))
        return self.pending

    def block_until_done(self) -> None:
        """Barrier on the in-flight async save (no-op when none). A
        failed drain re-raises here unless the caller already observed
        the exception through the future; the slot clears exactly when
        the future is finished (an interrupted wait keeps it)."""
        p = self.pending
        if p is None:
            return
        observed_before = p.exception_observed
        try:
            p.wait()
        except BaseException:
            if not p.done():
                raise      # interrupted mid-drain: keep the live future
            if self.pending is p:
                self.pending = None
            if not observed_before:
                raise
        else:
            if self.pending is p:
                self.pending = None

    def latest_step(self) -> int | None:
        d = Path(self.directory)
        steps = sorted(int(p.name[5:13]) for p in
                       d.glob("ckpt_*.manifest.json"))
        return steps[-1] if steps else None

    def restore(self, like_tree, step: int | None = None, *,
                subset=None, node_cache: bool = True,
                planned: bool | None = None, with_timings: bool = False):
        """Restore the latest (or a given) step through the planned
        collective read with the manager's io/config/session; the other
        arguments pass to :func:`restore_checkpoint`."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_checkpoint(
            Path(self.directory) / f"ckpt_{step:08d}", like_tree,
            subset=subset, io=self.io, config=self.config,
            session=self.session, node_cache=node_cache, planned=planned,
            with_timings=with_timings)

    def _gc(self):
        d = Path(self.directory)
        manifests = sorted(d.glob("ckpt_*.manifest.json"))
        for old in manifests[:-self.keep]:
            stem = old.name.replace(".manifest.json", "")
            for seg in d.glob(stem + ".seg*"):
                seg.unlink()
            old.unlink()
