from .ransac import find_tform_ransac, fit_affine_ls, RansacResult
from .pipeline import register_pair, RegistrationResult, im2mm, mm2im
from .groupwise import (groupwise_solve, groupwise_solve_sharded,
                        register_groupwise, register_groupwise_sharded,
                        GroupwiseResult)
