from benchmark.reference.codeps_ref.geometry.camera import (backproject,
                                          project, scale_intrinsics,
                                          scale_intrinsics_to_size)
from benchmark.reference.codeps_ref.geometry.pose import (rot_from_axisangle,
                                        transformation_from_parameters,
                                        transform_points, translation_matrix)
from benchmark.reference.codeps_ref.geometry.warp import warp_coordinates, warp_image

__all__ = [
    "backproject", "project", "scale_intrinsics",
    "scale_intrinsics_to_size", "rot_from_axisangle",
    "transformation_from_parameters", "transform_points",
    "translation_matrix", "warp_coordinates", "warp_image",
]
