from .ransac import find_tform_ransac, fit_affine_ls, RansacResult
from .pipeline import register_pair, RegistrationResult, im2mm, mm2im
from .groupwise import (groupwise_solve, register_groupwise,
                        GroupwiseResult)
