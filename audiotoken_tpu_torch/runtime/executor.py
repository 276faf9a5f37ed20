"""Corpus tokenization executor: host prefetch -> device encode -> async sink.

Counterpart of ``audiotoken_tpu/runtime/executor.py``. Three kinds of
thread: producer threads decode and cut files into fixed-shape segments
(``io/dataset.py``); the main thread feeds each batch to the encoder's
``dispatch``, which queues the device work and returns without waiting,
and queues the copy of its tokens to pinned host memory behind it, with an
event; a writer thread waits for each batch's event and hands the tokens
to the idempotent :class:`TokenSink`. A bounded queue between the main
thread and the writer (``pipeline_depth`` batches) lets dispatch run ahead
of the device by that much and no more.

An encoder on a mesh of several ranks (``parallel/mesh.py``) is driven as
the JAX package drives its dp mesh from one host: the files are not shared
out over the ranks. Rank 0 runs the segment stream, the manifest and the
sink, and broadcasts each batch to every rank of the mesh; every rank makes
the same encoder call, whose rows the mesh splits and gathers again; only
rank 0 writes. A stop message ends the other ranks' loop, also when rank 0
fails, and every rank returns rank 0's summary.
"""

import contextlib
import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import AUDIO_EXTS, TAR_EXTS, ZIP_EXTS
from ..io.audio import find_files, sanitize_path
from ..io.dataset import AudioSegmentStream, batched_segments
from ..io.sink import TokenSink
from ..logger import get_logger
from ..parallel import hosts
from ..parallel.shard import data_parallel_shardings
from .profiling import StageTimers

logger = get_logger(__name__)


class ThroughputMeter:
    """Audio seconds written, batches, and audio seconds per wall second."""

    def __init__(self):
        self.audio_seconds = 0.0
        self.batches = 0
        self.start = time.perf_counter()

    def update(self, seconds: float):
        self.audio_seconds += seconds
        self.batches += 1

    @property
    def wall(self) -> float:
        return time.perf_counter() - self.start

    @property
    def rtfx(self) -> float:
        return self.audio_seconds / max(self.wall, 1e-9)

    def summary(self) -> dict:
        return {
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall, 3),
            "rtfx": round(self.rtfx, 2),
            "batches": self.batches,
        }


def start_fetch(codes) -> Callable[[], np.ndarray]:
    """Queue the copy of ``codes`` to the host; returns the function that
    waits for it and gives the numpy array.

    A CUDA tensor is copied behind the work already queued on its stream
    into pinned host memory, and an event marks the copy's end: the waiting
    function waits for that event only, not for batches queued after it.
    Anything else (a CPU tensor, an array) converts when the function runs.
    """
    if isinstance(codes, torch.Tensor) and codes.is_cuda:
        host = torch.empty(codes.shape, dtype=codes.dtype, pin_memory=True)
        host.copy_(codes, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(codes.device))

        def fetch():
            done.synchronize()
            # a copy, so that the chunks the sink holds keep no pinned memory
            return host.numpy().copy()

        return fetch
    return lambda: np.asarray(codes)


def encode_batch_files(
    encoder,
    model_config,
    batch_size: int,
    outdir,
    chunk_size: float = 30,
    num_workers: int = 4,
    audio_files: Optional[List] = None,
    audio_dir=None,
    **kwargs,
) -> dict:
    """Tokenize a corpus into ``outdir`` (one ``<name>.npy`` of int16
    tokens [K, T] per audio file, or per member of a tar or zip); files in
    a manifest of ``outdir`` are skipped. ``audio_files`` lists the files,
    or ``audio_dir`` is searched for them (and its layout kept under
    ``outdir``). ``kwargs``: ``pipeline_depth`` (4) and
    ``prefetch_factor`` (4).

    With an encoder on a mesh of several ranks every rank of the mesh calls
    this with the same arguments; ``batch_size`` must divide over the
    mesh's dp ranks. Without a mesh, each process of a multi-process job
    takes its share of the files.

    Returns the summary: audio seconds, wall seconds, RTFx, batches, the
    stage spans and, where chunks failed, ``failed_files``.
    """
    mesh = getattr(encoder, "mesh", None)
    feed = None
    if mesh is not None and mesh.size > 1:
        dp = mesh.axis(data_parallel_shardings(mesh)[1][0])
        if batch_size % dp.size:
            raise ValueError(f"batch_size {batch_size} does not split over the mesh's "
                             f"dp = {dp.size} ranks: make it a multiple of {dp.size}")
        feed = _MeshFeed(mesh)
    if not audio_files and not audio_dir:
        raise ValueError("Either audio_files or audio_dir must be provided")
    if audio_files and audio_dir:
        raise ValueError("Provide either audio_files or audio_dir, not both")
    if feed is None:
        return _encode_files(encoder, model_config, batch_size, outdir, chunk_size,
                             num_workers, audio_files, audio_dir, None, kwargs)
    if mesh.rank != 0:
        return feed.follow(encoder)
    try:
        summary = _encode_files(encoder, model_config, batch_size, outdir, chunk_size,
                                num_workers, audio_files, audio_dir, feed, kwargs)
    except BaseException:
        feed.stop(None)
        raise
    feed.stop(summary)
    return summary


class _MeshFeed:
    """The batches of a corpus from rank 0 to every rank of a mesh: a header
    (kind, rows, samples, int16 or f32) and then the audio and its [B]
    lengths; the audio travels as int32 where it is int16 (NCCL has no
    int16). A stop header carries rank 0's outcome: the summary follows it,
    or the other ranks raise. Over NCCL the tensors travel on the rank's
    card, over gloo on the host."""

    BATCH, DONE, FAILED = 1, 0, -1

    def __init__(self, mesh):
        self.mesh = mesh
        self.device = mesh.device if dist.get_backend() == "nccl" else torch.device("cpu")

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=0)
        return t

    def _header(self, kind, rows=0, samples=0, int16=0) -> torch.Tensor:
        return self._bcast(torch.tensor([kind, rows, samples, int16], dtype=torch.int64,
                                        device=self.device))

    def batch(self, audio: np.ndarray, lengths: np.ndarray) -> None:
        """Rank 0: send one batch."""
        int16 = audio.dtype == np.int16
        self._header(self.BATCH, audio.shape[0], audio.shape[1], int(int16))
        wide = audio.astype(np.int32) if int16 else audio.astype(np.float32, copy=False)
        self._bcast(torch.from_numpy(np.ascontiguousarray(wide)).to(self.device))
        self._bcast(torch.from_numpy(np.asarray(lengths, np.int32)).to(self.device))

    def stop(self, summary: Optional[dict]) -> None:
        """Rank 0: end every rank's loop with ``summary``, or None after a failure."""
        self._header(self.FAILED if summary is None else self.DONE)
        if summary is not None:
            dist.broadcast_object_list([summary], src=0)

    def follow(self, encoder) -> dict:
        """Ranks other than 0: encode each batch rank 0 sends, as rank 0
        does, until the stop header; return rank 0's summary."""
        dispatch = getattr(encoder, "dispatch", None)
        while True:
            kind, rows, samples, int16 = self._header(0).tolist()
            if kind == self.FAILED:
                raise RuntimeError("encode_batch_files failed on rank 0 of the mesh")
            if kind == self.DONE:
                box = [None]
                dist.broadcast_object_list(box, src=0)
                return box[0]
            audio = self._bcast(torch.empty((rows, samples), device=self.device,
                                            dtype=torch.int32 if int16 else torch.float32))
            lengths = self._bcast(torch.empty((rows,), dtype=torch.int32, device=self.device))
            audio = audio.cpu().numpy().astype(np.int16) if int16 else audio.cpu().numpy()
            lengths = lengths.cpu().numpy()
            # the same call as rank 0's: its collectives meet rank 0's
            if dispatch:
                dispatch(audio, lengths)
            else:
                encoder(audio, lengths)


def _encode_files(encoder, model_config, batch_size, outdir, chunk_size, num_workers,
                  audio_files, audio_dir, feed: Optional[_MeshFeed], kwargs) -> dict:
    """:func:`encode_batch_files` on this process: its files, its sink, and
    with ``feed`` (rank 0 of a mesh) each batch sent to the other ranks
    before it is encoded."""
    outdir = sanitize_path(outdir)
    if audio_dir is not None:
        files = find_files(audio_dir, AUDIO_EXTS + TAR_EXTS + ZIP_EXTS)
    else:
        files = [str(f) for f in audio_files]

    manifest_name = "manifest.json"
    pc = hosts.process_count()
    if pc > 1 and feed is None:
        # each host takes a deterministic share of the files and writes its
        # own manifest into the shared outdir (the sink reads the union)
        pi = hosts.process_index()
        files = hosts.shard_files_for_host(files, pi, pc)
        manifest_name = f"manifest.p{pi}.json"
        logger.info("host %d/%d processing %d files", pi, pc, len(files))

    sink = TokenSink(outdir, rel_dir=str(audio_dir) if audio_dir else None,
                     manifest_name=manifest_name)
    files = [f for f in files if not sink.is_done(f)]
    if not files:
        logger.warning("all files already tokenized (manifest); nothing to do")
        return ThroughputMeter().summary()

    stream = AudioSegmentStream(
        audio_files=files,
        sample_rate=model_config.model_sample_rate,
        model_token_rate=model_config.model_token_rate,
        chunk_size=chunk_size,
        pad_token=model_config.pad_token or 0,
        transform=getattr(encoder, "host_transform", None),
        on_file_complete=sink.finish_file,
        prefer_int16=getattr(encoder, "accepts_int16", False),
        transform_int16_passthrough=getattr(encoder, "int16_device_transform", False),
        on_archive_complete=sink.finish_archive,
    )

    device = torch.device(getattr(encoder, "device", "cpu"))
    meter = ThroughputMeter()
    # Each thread's critical path. Main thread: segment_wait (blocked on the
    # producers), mesh_send (rank 0 of a mesh: the batch to the other ranks),
    # dispatch (H2D, the launches, queueing the copy back), writeq_put
    # (blocked on the writer). Writer: d2h_fetch (waiting for the
    # device), sink_write (disk). Spans of different threads overlap.
    timers = StageTimers(device=device)
    write_q: "queue.Queue" = queue.Queue(maxsize=int(kwargs.get("pipeline_depth", 4)))
    writer_error: List[BaseException] = []

    def writer():
        ctx = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        with ctx:
            while True:
                item = write_q.get()
                if item is None:
                    return
                if writer_error:
                    continue  # drain mode after a failure: keep the main thread unblocked
                try:
                    fetch, cfgs = item
                    with timers.span("d2h_fetch"):
                        arr = fetch()
                    if arr.ndim == 2:
                        arr = arr[:, None, :]  # semantic ids [B, T] -> [B, 1, T]
                    with timers.span("sink_write"):
                        for tok, cfg in zip(arr, cfgs):
                            if cfg is None:
                                continue  # a batch-padding row (io/dataset._stack)
                            try:
                                sink.add(tok, cfg)
                            except Exception as e:  # noqa: BLE001  (the file is reported failed)
                                logger.error("error saving tokens for %s: %s", cfg.file_name, e,
                                             exc_info=True)
                    meter.update(sum(c.length_seconds or 0.0 for c in cfgs if c))
                    if meter.batches % 50 == 0:
                        logger.info("batch %d: %.1fx real-time", meter.batches, meter.rtfx)
                except Exception as e:  # noqa: BLE001
                    # a device failure surfaces here, at the event or the
                    # copy: record it and drain, so that the main thread
                    # never blocks on a full queue, and let it raise
                    writer_error.append(e)
                    logger.error("writer thread failed: %s", e)

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()

    dispatch = getattr(encoder, "dispatch", None)
    batches = iter(batched_segments(stream, batch_size, num_workers=num_workers,
                                    prefetch=kwargs.get("prefetch_factor", 4)))
    try:
        while True:
            with timers.span("segment_wait"):
                item = next(batches, None)
            if item is None or writer_error:
                break
            audio, lengths, cfgs = item
            if feed is not None:
                with timers.span("mesh_send"):
                    feed.batch(audio, lengths)
            with timers.span("dispatch"):
                codes = dispatch(audio, lengths)[0] if dispatch else encoder(audio, lengths)
                fetch = start_fetch(codes)
            with timers.span("writeq_put"):
                write_q.put((fetch, cfgs))
    finally:
        write_q.put(None)
        wt.join()
    if writer_error:
        raise RuntimeError("token writer failed; corpus job aborted") from writer_error[0]

    leftovers = sink.pending_files()
    summary = meter.summary()
    summary["stages"] = timers.summary()
    timers.log()
    if leftovers:
        # a failed chunk leaves its whole file unwritten
        logger.error("%d file(s) with missing or failed chunks were NOT written: %s",
                     len(leftovers), leftovers)
        summary["failed_files"] = list(leftovers)
    logger.info("encode_batch_files done: %s", summary)
    return summary
