from .flow import (FlowPastObjectDataset, FlowPastObjectEnsemble,
                   NSFPSChannelDataset, NSLDCDataset, StokesMMSDataset,
                   synthetic_obstacles)
from .geometry_datasets import (Burg2DXT, ElasticFSDTDataset, PCVox,
                                ParametricNURBS,
                                TopoDataset3D, image_to_point_cloud,
                                nurbs_curve, synthesize_topology_3d)
from .loader import InMemoryDataset, NumpyLoader
from .parametric import (ImageIMBack, ImageIMBackNeumann, ImageIMBackObject,
                         KLSumStochastic, PointClouds, SyntheticPointClouds)
# data.ImageIMBack is the parametric dataset; the single-instance one of
# that name is data.single_instances.ImageIMBack (Disk's base)
from .single_instances import (AdvDiff1dRectangle, AdvDiff2dRectangle,
                               AllenCahnIceMeltRectangle, CircleIMBack,
                               Cuboid, CuboidManufactured, Disk,
                               KLSumSingleInstance, LShaped, Rectangle,
                               RectangleHelmholtzDeltaForce,
                               RectangleHelmholtzManufactured, RectangleIM,
                               RectangleIMBack, RectangleManufactured,
                               RectangleManufacturedNonZeroBC,
                               RectangleManufacturedStokes,
                               SingleInstanceDataset,
                               SpaceTimeRectangleManufactured,
                               VoxelIMBackRAW, load_raw)

__all__ = ["NumpyLoader", "InMemoryDataset", "PointClouds",
           "SyntheticPointClouds", "ImageIMBack", "ImageIMBackObject",
           "ImageIMBackNeumann", "KLSumStochastic", "KLSumSingleInstance",
           "SingleInstanceDataset", "Rectangle",
           "RectangleManufactured", "Cuboid", "CuboidManufactured",
           "load_raw", "VoxelIMBackRAW", "StokesMMSDataset", "NSLDCDataset",
           "FlowPastObjectDataset", "FlowPastObjectEnsemble",
           "NSFPSChannelDataset", "synthetic_obstacles", "PCVox",
           "ParametricNURBS", "TopoDataset3D", "image_to_point_cloud",
           "nurbs_curve", "synthesize_topology_3d", "Burg2DXT",
           "RectangleManufacturedNonZeroBC", "SpaceTimeRectangleManufactured",
           "AdvDiff1dRectangle", "AdvDiff2dRectangle",
           "AllenCahnIceMeltRectangle", "RectangleHelmholtzManufactured",
           "RectangleHelmholtzDeltaForce", "RectangleManufacturedStokes",
           "RectangleIM", "RectangleIMBack", "CircleIMBack", "LShaped",
           "Disk", "ElasticFSDTDataset"]
