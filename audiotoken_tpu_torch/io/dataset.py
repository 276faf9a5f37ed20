"""Streaming segment producer for corpus tokenization.

Counterpart of ``audiotoken_tpu/io/dataset.py``. Producer threads decode
and cut files into fixed-shape segments (the decode hot path is native
C++ or numpy, which release the interpreter lock) into a bounded queue,
with one end-of-stream sentinel per producer thread.

Segmentation: fixed ``chunk_size * sample_rate`` segments, right-padded
with ``pad_token``, each with its count of valid samples; segments shorter
than 0.2 s are dropped.
"""

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..configs import AUDIO_EXTS, TAR_EXTS, ZIP_EXTS, AudioConfig
from ..logger import get_logger
from .audio import iterate_tar, iterate_zip, process_audio_chunks

logger = get_logger(__name__)

MIN_SEGMENT_SECONDS = 0.2


@dataclass
class Segment:
    audio: np.ndarray  # [segment_length] f32 or int16, padded
    n_valid: int  # valid samples (the prefix; the rest is pad_token)
    config: AudioConfig


class AudioSegmentStream:
    """Iterates :class:`Segment` s over a file corpus.

    ``on_file_complete(file_name, n_segments)`` fires after a file's last
    segment is emitted; the token sink uses it to know when to write.
    ``on_archive_complete(path, member_names)`` fires after the last member
    of a tar or zip has been read whole, so that the sink can record the
    archive itself as done once every member is written.
    ``skip_segments`` maps a file name to the count of its leading segments
    not to emit (a resume past segments already used); they still count in
    ``on_file_complete``'s ``n_segments``.
    """

    def __init__(
        self,
        audio_files: Sequence[str],
        sample_rate: int,
        model_token_rate: int,
        chunk_size: float,
        pad_token: int = 0,
        transform: Optional[Callable] = None,
        on_file_complete: Optional[Callable[[str, int], None]] = None,
        prefer_int16: bool = False,
        transform_int16_passthrough: bool = False,
        on_archive_complete: Optional[Callable[[str, List[str]], None]] = None,
        skip_segments: Optional[Dict[str, int]] = None,
    ):
        self.audio_files = list(audio_files)
        self.sample_rate = sample_rate
        self.model_token_rate = model_token_rate
        self.chunk_size = chunk_size
        self.segment_length = int(chunk_size * sample_rate)
        self.pad_token = pad_token
        self.transform = transform
        self.on_file_complete = on_file_complete
        self.on_archive_complete = on_archive_complete
        self.skip_segments = skip_segments or {}
        # int16 passes through only to encoders that scale it on the device,
        # or (transform_int16_passthrough) that apply the host transform's
        # equivalent on the device for int16 input (HubertEncoder); any
        # other transform needs floats. The raw flag is kept so that
        # batched_segments' worker sub-streams get the same resolution.
        self.transform_int16_passthrough = transform_int16_passthrough
        self.prefer_int16 = prefer_int16 and (transform is None or transform_int16_passthrough)

    def _segments_of_chunk(
        self, waveform: np.ndarray, file_name: str, chunk_start: int
    ) -> Iterator[Segment]:
        """Cut one decoded chunk into fixed-shape segments; int16 chunks
        (PCM16 at the model rate) stay int16 and skip the host transform."""
        length = waveform.shape[-1]
        if self.transform and waveform.dtype != np.int16:
            waveform = self.transform(np.asarray(waveform, np.float32))
        dtype = waveform.dtype if waveform.dtype == np.int16 else np.float32
        min_samples = int(MIN_SEGMENT_SECONDS * self.sample_rate)
        for i in range(0, length, self.segment_length):
            seg = np.asarray(waveform[0, i : i + self.segment_length], dtype)
            if seg.shape[-1] < min_samples:
                logger.warning("segment at %ds of %s too short; skipping",
                               (chunk_start + i) // self.sample_rate, file_name)
                continue
            n = seg.shape[0]
            if n < self.segment_length:
                seg = np.pad(seg, (0, self.segment_length - n), constant_values=self.pad_token)
            cfg = AudioConfig(
                file_name=file_name,
                start_idx=chunk_start + i,
                end_idx=chunk_start + i + n,
                length_seconds=n / self.sample_rate,
                length_samples=n,
                model_token_rate=self.model_token_rate,
            )
            yield Segment(seg, n, cfg)

    def _iter_file(self, path: str) -> Iterator[Segment]:
        archive = path.endswith(TAR_EXTS + ZIP_EXTS)
        if path.endswith(TAR_EXTS):
            gen = iterate_tar(path, self.sample_rate, self.chunk_size)
        elif path.endswith(ZIP_EXTS):
            gen = iterate_zip(path, self.sample_rate, self.chunk_size)
        elif path.endswith(AUDIO_EXTS):
            gen = process_audio_chunks(path, None, self.sample_rate, self.chunk_size,
                                       prefer_int16=self.prefer_int16)
        else:
            logger.error("unsupported file type: %s", path)
            return
        counts: dict = {}
        offsets: dict = {}
        prev_name = None
        for waveform, name in gen:
            if prev_name is not None and name != prev_name:
                self._complete(prev_name, counts)
            prev_name = name
            start = offsets.get(name, 0)
            offsets[name] = start + waveform.shape[-1]
            for seg in self._segments_of_chunk(waveform, name, start):
                counts[name] = counts.get(name, 0) + 1
                if counts[name] > self.skip_segments.get(name, 0):
                    yield seg
        if prev_name is not None:
            self._complete(prev_name, counts)
        if archive and self.on_archive_complete:
            self.on_archive_complete(path, list(offsets))

    def _complete(self, name: str, counts: dict) -> None:
        if self.on_file_complete:
            self.on_file_complete(name, counts.get(name, 0))

    def __iter__(self) -> Iterator[Segment]:
        for path in self.audio_files:
            try:
                yield from self._iter_file(str(path))
            except Exception as e:  # noqa: BLE001  (one bad file must not stop the corpus)
                logger.error("error processing %s: %s", path, e, exc_info=True)


def batched_segments(
    stream: AudioSegmentStream,
    batch_size: int,
    num_workers: int = 2,
    prefetch: int = 8,
    drop_last: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray, List[Optional[AudioConfig]]]]:
    """Fixed-shape batches ``(audio [B, segment_length], lengths [B] int32,
    configs)`` from background producer threads.

    Files are dealt round-robin to ``num_workers`` producer threads; a
    bounded queue applies backpressure. Every batch has exactly
    ``batch_size`` rows: the last partial batch is padded by repeating its
    final segment, with ``None`` configs for the pad rows (consumers skip
    them), so the encoder sees one batch shape for the whole corpus.
    ``drop_last`` drops the partial batch instead.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(2, prefetch) * batch_size)
    n_workers = max(1, min(num_workers, len(stream.audio_files) or 1))
    files_per_worker = [stream.audio_files[i::n_workers] for i in range(n_workers)]

    def worker(files):
        sub = AudioSegmentStream(
            files, stream.sample_rate, stream.model_token_rate, stream.chunk_size,
            stream.pad_token, stream.transform, stream.on_file_complete,
            prefer_int16=stream.prefer_int16,
            transform_int16_passthrough=stream.transform_int16_passthrough,
            on_archive_complete=stream.on_archive_complete,
            skip_segments=stream.skip_segments,
        )
        try:
            for seg in sub:
                q.put(seg)
        finally:
            q.put(None)  # one sentinel per producer

    threads = [threading.Thread(target=worker, args=(f,), daemon=True)
               for f in files_per_worker]
    for t in threads:
        t.start()

    finished = 0
    batch: List[Segment] = []
    while finished < n_workers:
        item = q.get()
        if item is None:
            finished += 1
            continue
        batch.append(item)
        if len(batch) == batch_size:
            yield _stack(batch)
            batch = []
    if batch and not drop_last:
        yield _stack(batch, pad_to=batch_size)
    for t in threads:
        t.join()


def _stack(batch: List[Segment], pad_to: int = 0):
    n_pad = max(0, pad_to - len(batch))
    if len({s.audio.dtype for s in batch}) > 1:
        # int16 (PCM16 at the model rate) beside float32 (resampled): scale
        # the int16 rows, or np.stack's upcast would give the model +-32768
        arrs = [s.audio.astype(np.float32) / 32768.0 if s.audio.dtype == np.int16 else s.audio
                for s in batch]
    else:
        arrs = [s.audio for s in batch]
    audio = np.stack(arrs + [arrs[-1]] * n_pad)
    # [B] int32 valid-prefix lengths, not a [B, T] mask: the encoders
    # expand them to the same mask on the device, at a fraction of the bytes
    lengths = np.asarray([s.n_valid for s in batch] + [batch[-1].n_valid] * n_pad, np.int32)
    return audio, lengths, [s.config for s in batch] + [None] * n_pad
