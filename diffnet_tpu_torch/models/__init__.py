from .field import DirectField
from .networks import AE, UNet, VAE, GoodNetwork

__all__ = ["DirectField", "AE", "VAE", "UNet", "GoodNetwork"]
