from .field import DirectField
from .gan import (Discriminator, FCGenerator, LatentGenerator,
                  ResidualFCGenerator)
from .networks import (AE, VAE, GoodNetwork, ImplicitConv, LocalConv2d,
                       MultiOutUNet, ResNetED, UNet, UNet3D, UNetRes)
from .pointnets import (DGCNN2D, MLP, ConvNet1D, EikonalLinear, ImmDiff,
                        ImmDiffLarge, ImmDiffLargeNormals, ImmDiffVAE,
                        graph_feature, knn_indices)

__all__ = ["DirectField", "AE", "VAE", "UNet", "UNet3D", "MultiOutUNet",
           "GoodNetwork", "UNetRes", "ImplicitConv", "ResNetED",
           "LocalConv2d", "MLP", "ConvNet1D", "ImmDiff", "ImmDiffVAE",
           "ImmDiffLarge", "ImmDiffLargeNormals", "EikonalLinear", "DGCNN2D",
           "knn_indices", "graph_feature", "FCGenerator",
           "ResidualFCGenerator", "LatentGenerator", "Discriminator"]
