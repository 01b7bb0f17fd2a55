"""Dtype policy, OpenCV-compatible rounding/saturation and border padding."""
from tpuimage_torch.core.borders import (BORDER_CONSTANT, BORDER_REFLECT, BORDER_REFLECT_101,
                                         BORDER_REPLICATE, pad2d)
from tpuimage_torch.core.dtypes import descale, f32, i32, round_half_even, saturate_u8

__all__ = ["BORDER_CONSTANT", "BORDER_REFLECT", "BORDER_REFLECT_101", "BORDER_REPLICATE",
           "pad2d", "descale", "f32", "i32", "round_half_even", "saturate_u8"]
