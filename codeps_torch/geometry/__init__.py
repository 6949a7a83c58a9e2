from codeps_torch.geometry.camera import (backproject, make_intrinsics,
                                          project, scale_intrinsics,
                                          scale_intrinsics_to_size)
from codeps_torch.geometry.pose import (rot_from_axisangle,
                                        transformation_from_parameters,
                                        transform_points, translation_matrix)
from codeps_torch.geometry.warp import warp_coordinates, warp_image

__all__ = [
    "backproject", "make_intrinsics", "project", "scale_intrinsics",
    "scale_intrinsics_to_size", "rot_from_axisangle",
    "transformation_from_parameters", "transform_points",
    "translation_matrix", "warp_coordinates", "warp_image",
]
