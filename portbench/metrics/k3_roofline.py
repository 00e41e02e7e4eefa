"""k3_roofline [%]: K3, the GRB equal-arrival-time surface (csrc/grb_eats.cu);
read as every kernel's roofline is (kernel_roofline.py)."""

from portbench.metrics.kernel_roofline import read  # noqa: F401
