"""Which upstream checkpoint serves each entry of the weight store, and its
conversion.

The store's entries (``STORE``) are the files a converted directory holds,
``<entry>.npz``. :func:`source` finds an entry's checkpoint under a staged
directory (default ``$AUDIOTOKEN_ARTIFACTS``), :func:`convert_checkpoint`
turns a checkpoint into the entry's parameter tree, and
:func:`artifact_tree` joins the two with the hub route for
``weights="artifacts"``. ``cli.py convert`` and
``scripts/convert_real_torch.py`` go through the same functions.
"""

import os
from typing import Optional

import torch

from .store import state_dict_to_numpy

STORE = ("acoustic", "hubert", "hubert_kmeans", "w2vbert", "w2vbert_vq",
         "gpt_semantic_s_en", "gpt_semantic_m_hi", "bark_fine")

#: the entries staged under one of these names, in lookup order; where none
#: is staged their checkpoint comes from the hub as a ``transformers`` model.
#: The other entries resolve through ``configs.ARTIFACTS``.
STAGED = {
    "acoustic": ("encodec_24khz.safetensors", "encodec_24khz.pt", "encodec_24khz.th"),
    "hubert": ("mhubert_base.safetensors", "mhubert_base.pt",
               os.path.join("voidful__mhubert-base", "pytorch_model.bin"),
               os.path.join("voidful__mhubert-base", "model.safetensors")),
    "bark_fine": ("bark_fine.pt", "fine_2.pt", "fine.pt"),
}


def source(name: str, root: Optional[str] = None, artifact: Optional[str] = None):
    """The checkpoint file of store entry ``name`` under ``root`` (default
    ``$AUDIOTOKEN_ARTIFACTS``): for an entry of ``STAGED`` the first of its
    names that exists, else None; for the others
    ``configs.ARTIFACTS[artifact]`` resolved (staged, else through
    ``huggingface_hub``), ``artifact`` defaulting to the entry's key there."""
    if root is None:
        root = os.environ.get("AUDIOTOKEN_ARTIFACTS", "")
    if name in STAGED:
        for cand in STAGED[name] if root else ():
            path = os.path.join(root, cand)
            if os.path.exists(path):
                return path
        return None
    from ..configs import ARTIFACTS, Wav2VecBertConfig

    if artifact is None:
        artifact = Wav2VecBertConfig.weights_artifact if name == "w2vbert" else name
    return ARTIFACTS[artifact].resolve(root)


def load_torch_sd(path: str):
    """A checkpoint file -> numpy state dict: ``.safetensors`` through the
    port's own reader, anything else (``.pt``, ``.th``, ``.bin``, ``.pkl``)
    through ``torch.load(weights_only=True)``, with a nanoGPT-style
    ``{"model": state_dict, ...}`` unwrapped."""
    if path.endswith(".safetensors"):
        from .safetensors import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict) and all(
            hasattr(v, "shape") for v in sd["model"].values()):
        sd = sd["model"]
    return state_dict_to_numpy(sd)


def convert_checkpoint(name: str, src, cfg=None):
    """The parameter tree of store entry ``name`` from ``src``: a checkpoint
    path, or a numpy state dict (for ``hubert_kmeans`` a path, or an object
    with ``cluster_centers_``). ``cfg`` replaces the model's full-size
    configuration (GPT and Bark-fine)."""
    if name == "hubert_kmeans":
        from .quantizers import convert_kmeans

        return {"centroids": convert_kmeans(src)}
    sd = load_torch_sd(src) if isinstance(src, (str, os.PathLike)) else src
    if name == "acoustic":
        from .encodec import convert_encodec

        return convert_encodec(sd)
    if name == "hubert":
        from .hubert import convert_hubert

        return convert_hubert(sd)
    if name == "w2vbert":
        from .w2vbert import convert_w2vbert

        return convert_w2vbert(sd)
    if name == "w2vbert_vq":
        from .quantizers import convert_vq

        return {"codebook": convert_vq(sd)}
    if name in ("gpt_semantic_s_en", "gpt_semantic_m_hi"):
        from ..nn.gpt import GPTConfig
        from .gpt import convert_gpt

        return convert_gpt(sd, cfg or GPTConfig())
    if name == "bark_fine":
        from ..nn.bark_fine import BarkFineConfig
        from .bark import convert_bark_fine

        return convert_bark_fine(sd, cfg or BarkFineConfig())
    raise ValueError(f"unknown store entry {name}")


def _hub_state_dict(name: str, model_id=None):
    """The hub route of an unstaged entry of ``STAGED``: ``transformers``'
    ``from_pretrained`` -> numpy state dict in HF naming. Raises ImportError
    where ``transformers`` is missing (as on the card)."""
    import transformers  # type: ignore

    if name == "acoustic":
        m = transformers.EncodecModel.from_pretrained("facebook/encodec_24khz")
    elif name == "hubert":
        m = transformers.HubertModel.from_pretrained(model_id)
    else:
        m = transformers.BarkFineModel.from_pretrained("suno/bark", subfolder="fine_acoustics")
    return state_dict_to_numpy(m.state_dict())


def artifact_tree(name: str, cfg=None, artifact: Optional[str] = None, model_id=None):
    """``weights="artifacts"``: the tree of store entry ``name`` from its
    :func:`source`, else (an unstaged entry of ``STAGED``) from the hub's
    ``model_id``."""
    src = source(name, artifact=artifact)
    if src is None:
        try:
            src = _hub_state_dict(name, model_id)
        except Exception as e:  # noqa: BLE001  (ImportError, or any hub failure)
            raise FileNotFoundError(
                f"{name} checkpoint unavailable: stage one of {list(STAGED[name])} under "
                f"$AUDIOTOKEN_ARTIFACTS, or pass weights=<dir> of a converted store; the hub "
                f"route failed: {e}") from e
    return convert_checkpoint(name, src, cfg)
