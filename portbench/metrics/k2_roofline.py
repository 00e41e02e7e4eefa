"""k2_roofline [%]: K2, the Me2017 shell dynamics (csrc/me2017_dynamics.cu);
read as every kernel's roofline is (kernel_roofline.py)."""

from portbench.metrics.kernel_roofline import read  # noqa: F401
