"""k1_roofline [%]: K1, the SVD-surrogate MLP (csrc/svd_mlp.cu). The counted
bound (the larger of its operations at the f32 peak and its bytes at the
memory rate, from the configuration's counts file) over its device time from
the profiler, launch by launch over the first counted calls of the traced
slice.; read as every kernel's roofline is (kernel_roofline.py)."""

from portbench.metrics.kernel_roofline import read  # noqa: F401
