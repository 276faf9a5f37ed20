"""``weights="artifacts"`` in the port's tests: an empty or staged
``$AUDIOTOKEN_ARTIFACTS`` and no hub route, so that no test reaches the
network. The test files that resolve ``"artifacts"`` import :func:`offline`
from here."""

import os

import pytest


def _refuse(*args, **kwargs):
    raise OSError("the hub is not reachable from the tests")


def offline(monkeypatch, root):
    """Stage ``root`` as ``$AUDIOTOKEN_ARTIFACTS`` and make both hub routes
    (``transformers``' ``from_pretrained`` and ``hf_hub_download``) raise."""
    from audiotoken_tpu_torch.convert import checkpoints

    monkeypatch.setattr(checkpoints, "_hub_state_dict", _refuse)
    try:
        import huggingface_hub
    except ImportError:
        pass
    else:
        monkeypatch.setattr(huggingface_hub, "hf_hub_download", _refuse)
    monkeypatch.setenv("AUDIOTOKEN_ARTIFACTS", str(root))


@pytest.mark.parametrize("name", ["acoustic", "hubert_kmeans"])
def test_offline_refuses_both_hub_routes(monkeypatch, tmp_path, name):
    """An unstaged entry of ``STAGED`` (the ``transformers`` route) and one of
    ``configs.ARTIFACTS`` (the ``hf_hub_download`` route) both fail with
    the refusal, not a download."""
    from audiotoken_tpu_torch.convert.checkpoints import artifact_tree

    if name == "hubert_kmeans":
        pytest.importorskip("huggingface_hub")
    offline(monkeypatch, tmp_path)
    assert os.environ["AUDIOTOKEN_ARTIFACTS"] == str(tmp_path)
    with pytest.raises(FileNotFoundError, match="not reachable from the tests"):
        artifact_tree(name)
