"""k4_roofline: the summed roofline bounds of the traced window's K4
calls (from each call's shapes, ``portbench/flops.py``) over the device
time of the operations launched inside the range around K4's wrapper."""
from portbench.trace import roofline_share


def read(run):
    return roofline_share(run, "pb.k4")
