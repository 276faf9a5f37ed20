"""Weight store reader (the converters arrive with a later slice)."""

from .store import load_params

__all__ = ["load_params"]
