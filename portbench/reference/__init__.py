"""The plain reference that decides ``correct``: a frozen copy of the
port's plain forms (``tpuimage_torch`` at the commit that added this
benchmark), with every kernel replaced by its plain PyTorch version
(``ops/kernels.py``) and the host library's C++ replaced by its numpy
form. It imports nothing of the port or of the JAX package, and works
out every table, quad and homography again from the inputs.

``docscan`` and ``landscape`` hold the entry points the checks call;
``lower_precision`` is the control: the same reference with every
float32 value rounded to bfloat16.
"""
