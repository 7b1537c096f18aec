from .field import DirectField

__all__ = ["DirectField"]
