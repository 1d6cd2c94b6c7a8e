from . import se3

__all__ = ["se3"]
