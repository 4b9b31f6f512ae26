"""The check-node kernel's share of its roofline (bytes at 3.35 TB/s) over
the traced window; moves decoded_mbps."""

from pbcore.readers import roofline_share


def read(run):
    return roofline_share(run, "cn")
