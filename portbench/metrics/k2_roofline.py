"""k2_roofline: the summed roofline bounds of the traced window's K2
calls (from each call's shapes, ``portbench/flops.py``) over the device
time of the operations launched inside the range around K2's wrapper."""
from portbench.trace import roofline_share


def read(run):
    return roofline_share(run, "pb.k2")
