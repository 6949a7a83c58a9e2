from benchmark.reference.codeps_ref.models.codeps_net import (CodepsModules,
                                                              build_modules)

__all__ = ["CodepsModules", "build_modules"]
