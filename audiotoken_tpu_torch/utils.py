"""Host-side utilities: process affinity, dataset listings, one-off token
files. Counterpart of ``audiotoken_tpu/utils.py``; the corpus path itself
writes through the idempotent ``io/sink.py``."""

import os
from typing import List, Optional, Sequence

import numpy as np

from .configs import AudioConfig
from .logger import get_logger

logger = get_logger(__name__)


def set_process_affinity(process_id: int, cores: Sequence[int]) -> None:
    """Pin a process to CPU cores; logs a warning where the platform cannot."""
    try:
        os.sched_setaffinity(process_id, set(cores))
    except (AttributeError, OSError) as e:
        logger.warning("could not set affinity: %s", e)


def get_dataset_files(indir: Optional[str], hf_dataset: Optional[str]) -> List[str]:
    """The audio files under a directory, a single file, or the audio paths
    of a Hugging Face dataset (needs ``datasets`` and ``HF_TOKEN``)."""
    if not (indir or hf_dataset):
        raise ValueError("Either hf_dataset or indir must be provided")
    from .io.audio import find_audio_files

    if indir and os.path.isdir(indir):
        return find_audio_files(indir)
    if indir:
        return [indir]
    if not os.environ.get("HF_TOKEN"):
        raise ValueError("set HF_TOKEN to list a hub dataset")
    from datasets import load_dataset  # type: ignore

    ds = load_dataset(hf_dataset, "s", trust_remote_code=True,
                      token=os.environ["HF_TOKEN"])["train"]
    return [ds[i]["audio"]["path"] for i in range(len(ds))]


def save_audio_tokens(tokens: np.ndarray, audio_pointer: AudioConfig, root_dir: str) -> None:
    """Write ``<basename>.npy``, the tokens cut to ``length_tokens``. An
    existing file is overwritten, never appended to, so a rerun gives the
    same file."""
    base = os.path.splitext(os.path.basename(audio_pointer.file_name))[0]
    os.makedirs(root_dir, exist_ok=True)
    path = os.path.join(root_dir, f"{base}.npy")
    out = np.asarray(tokens)[:, : audio_pointer.length_tokens]
    np.save(path, out)
    logger.debug("saved %s %s", path, out.shape)


def collate_audio_tokens(
    prev_tokens: np.ndarray, new_tokens: np.ndarray, audio_pointer: AudioConfig
) -> np.ndarray:
    """Append a chunk's tokens and cut to the file's ``length_tokens``."""
    tokens = np.hstack([prev_tokens, np.asarray(new_tokens)])
    return tokens[:, : audio_pointer.length_tokens]
