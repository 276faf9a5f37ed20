"""Idempotent token sink with a restart manifest.

Counterpart of ``audiotoken_tpu/io/sink.py``:

* each file's tokens are written once, atomically (tmp + rename), after
  all its chunks have arrived, and a manifest records the completed files
  so that a rerun skips them (the upstream project appended duplicate
  tokens to existing files on a rerun);
* each chunk is trimmed to its own ``chunk_length_tokens`` and the chunks
  are joined in start-index order.

Memory: pending chunks are held in RAM up to ``max_pending_bytes``
(default 256 MB); beyond that they spill to ``<outdir>/.staging`` and are
read back when their file is written.

Archives: a tar or zip is recorded in the manifest under its own path
once every member it held is written (``finish_archive``), so that a rerun
skips it without reading it.

Several hosts: each writes its own manifest (``manifest.p<i>.json``, named
by the executor); ``is_done`` consults the union of every
``manifest*.json`` in the outdir, so hosts sharing a filesystem never
overwrite each other's records and a reshard still skips finished files.
"""

import glob
import json
import os
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..configs import AudioConfig
from ..logger import get_logger

logger = get_logger(__name__)


class TokenSink:
    """Collects per-chunk tokens and writes one .npy per audio file."""

    def __init__(
        self,
        outdir: str,
        rel_dir: Optional[str] = None,
        manifest_name: str = "manifest.json",
        max_pending_bytes: int = 256 << 20,
    ):
        self.outdir = str(outdir)
        self.rel_dir = str(rel_dir) if rel_dir else None
        os.makedirs(self.outdir, exist_ok=True)
        # value: the chunk's array (in RAM) or the path it spilled to
        self._pending: Dict[str, Dict[int, Union[np.ndarray, str]]] = {}
        self._expected: Dict[str, int] = {}
        self._archives: Dict[str, set] = {}  # archive path -> its members' names
        self._lock = threading.Lock()
        self._manifest_path = os.path.join(self.outdir, manifest_name)
        # the union of every host's manifest (read only, for is_done); this
        # sink's own manifest records only its own completions
        self._done_union = self._load_manifests()
        self._done = self._load_one(self._manifest_path)
        self._max_pending_bytes = int(max_pending_bytes)
        self._pending_bytes = 0
        self._staging = os.path.join(self.outdir, ".staging")
        self._spill_seq = 0

    @staticmethod
    def _load_one(path: str) -> set:
        if not os.path.exists(path):
            return set()
        try:
            with open(path) as f:
                return set(json.load(f)["completed"])
        except (OSError, ValueError, KeyError, TypeError):
            logger.warning("corrupt manifest at %s; ignoring it", path)
            return set()

    def _load_manifests(self) -> set:
        done = set()
        for path in glob.glob(os.path.join(self.outdir, "manifest*.json")):
            done.update(self._load_one(path))
        return done

    def _save_manifest(self) -> None:
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"completed": sorted(self._done)}, f)
        os.replace(tmp, self._manifest_path)

    def is_done(self, file_name: str) -> bool:
        return file_name in self._done or file_name in self._done_union

    def _out_path(self, file_name: str) -> str:
        """``<outdir>/<base>.npy``, or with ``rel_dir`` the file's directory
        under it kept below ``outdir``. A name outside ``rel_dir`` (a tar or
        zip member's) is written flat: joined as it is, its ``..`` parts
        would lead out of ``outdir``."""
        base = os.path.splitext(os.path.basename(file_name))[0]
        rel = os.path.relpath(file_name, start=self.rel_dir) if self.rel_dir else ""
        if not rel or rel.split(os.sep)[0] == os.pardir:
            return os.path.join(self.outdir, f"{base}.npy")
        d = os.path.join(self.outdir, os.path.dirname(rel))
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{base}.npy")

    def _spill(self, trimmed: np.ndarray) -> str:
        os.makedirs(self._staging, exist_ok=True)
        path = os.path.join(self._staging, f"chunk{self._spill_seq:09d}.npy")
        self._spill_seq += 1
        np.save(path, trimmed)
        return path

    def add(self, tokens: np.ndarray, cfg: AudioConfig) -> None:
        """tokens [K, T_chunk] of the chunk that starts at ``cfg.start_idx``."""
        trimmed = np.asarray(tokens)[:, : cfg.chunk_length_tokens]
        with self._lock:
            if (self._pending_bytes + trimmed.nbytes > self._max_pending_bytes
                    and self._pending_bytes > 0):
                entry: Union[np.ndarray, str] = self._spill(trimmed)
            else:
                entry = trimmed
                self._pending_bytes += trimmed.nbytes
            self._pending.setdefault(cfg.file_name, {})[cfg.start_idx or 0] = entry
            self._maybe_flush(cfg.file_name)

    def finish_file(self, file_name: str, num_chunks: int) -> None:
        """The producer's count of the file's chunks."""
        with self._lock:
            self._expected[file_name] = num_chunks
            self._maybe_flush(file_name)

    def finish_archive(self, path: str, members: List[str]) -> None:
        """The producer has read the archive at ``path`` whole; it held
        ``members``."""
        with self._lock:
            self._archives[path] = set(members)
            self._close_archives()

    def _close_archives(self) -> None:
        done = [p for p, members in self._archives.items() if all(map(self.is_done, members))]
        for path in done:
            del self._archives[path]
            self._done.add(path)
        if done:
            self._save_manifest()

    def _materialize(self, entry: Union[np.ndarray, str]) -> np.ndarray:
        if isinstance(entry, str):
            arr = np.load(entry)
            try:
                os.remove(entry)
            except OSError:
                pass
            return arr
        self._pending_bytes -= entry.nbytes
        return entry

    def _maybe_flush(self, file_name: str) -> None:
        exp = self._expected.get(file_name)
        chunks = self._pending.get(file_name, {})
        if exp is None or len(chunks) < exp:
            return
        ordered = [self._materialize(chunks[k]) for k in sorted(chunks)]
        tokens = np.concatenate(ordered, axis=1) if ordered else np.zeros((0, 0), np.int16)
        path = self._out_path(file_name)
        tmp = path + ".tmp.npy"
        np.save(tmp, tokens)
        os.replace(tmp, path)
        self._done.add(file_name)
        self._save_manifest()
        self._pending.pop(file_name, None)
        del self._expected[file_name]
        logger.debug("wrote %s: %s", path, tokens.shape)
        self._close_archives()

    def pending_files(self) -> List[Tuple[str, int]]:
        """(file, chunks received) of every file not written."""
        with self._lock:
            return [(f, len(c)) for f, c in self._pending.items()]
