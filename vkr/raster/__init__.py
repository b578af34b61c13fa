from vkr.raster.setup import (
    transform_vertices,
    transform_normals,
    clip_near_triangles,
    triangle_setup,
    bin_triangles,
    TriangleSetup,
)
from vkr.raster.kernel import (
    raster_tiles,
    raster_tiles_xla,
    rasterize_reference,
)
from vkr.raster.resolve import (
    corner_attributes,
    pixel_barycentrics,
    interpolate,
)
from vkr.raster.pipeline import rasterize, VisibilityBuffer
