"""Dtype policy, OpenCV-compatible rounding/saturation and border padding."""
