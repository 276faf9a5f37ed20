"""audiotoken_tpu_torch — the PyTorch and CUDA port of audiotoken_tpu.

Runs on an NVIDIA Hopper GPU (H100), with hand-written CUDA kernels where
the JAX package had Pallas kernels and plain PyTorch elsewhere. Ported so
far: acoustic encode (SEANet encoder + residual VQ), through
``AudioToken(Tokenizers.acoustic, ...).encode`` and ``AcousticEncoder``;
semantic_s encode (HuBERT layer 11 + k-means), through
``AudioToken(Tokenizers.semantic_s, ...).encode`` and ``HubertEncoder``;
semantic_m encode (fbank + w2v-BERT conformer + VQ), through
``AudioToken(Tokenizers.semantic_m, ...).encode`` and
``Wav2VecBertEncoder``; acoustic decode (``AcousticDecoder``) and semantic
decode (GPT -> Bark-fine -> EnCodec decoder, ``Wav2VecBertDecoder`` and
``HubertDecoder``), through ``AudioToken.decode`` / ``decode_batch``; and
the corpus path, ``AudioToken.encode_batch_files`` (``runtime/executor.py``),
with bytes input, tar and zip corpora, the native libav decoder and the
CLI (``python -m audiotoken_tpu_torch.cli``).

Imports ``torch`` and ``numpy``, never JAX. The device is explicit: the
default is CUDA, and ``device="cpu"`` runs every kernel's plain PyTorch
version. Importing the package builds nothing; the kernels are compiled
at first use on a CUDA tensor (``ops/_build.py``).
"""

from .api import AudioToken
from .configs import AUDIO_EXTS, TAR_EXTS, ZIP_EXTS, Tokenizers
from .decoders import AcousticDecoder, HubertDecoder, Wav2VecBertDecoder
from .encoders import AcousticEncoder, HubertEncoder, Wav2VecBertEncoder
from .io.audio import read_audio

__version__ = "0.1.0"

__all__ = [
    "AudioToken",
    "AcousticDecoder",
    "AcousticEncoder",
    "HubertDecoder",
    "HubertEncoder",
    "Tokenizers",
    "Wav2VecBertDecoder",
    "Wav2VecBertEncoder",
    "read_audio",
    "AUDIO_EXTS",
    "TAR_EXTS",
    "ZIP_EXTS",
    "__version__",
]
