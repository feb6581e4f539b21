"""Roofline share of the CT window solves' normal-equation assemblies in
the traced scans (%): the per-cloud scan-block calls' bounds (hgbench/
roofline/ct_scan_block.py) over the device time of every operation
launched inside those calls (layer: kernels)."""

from hgbench.lib import names
from hgbench.lib.peaks import roofline_pct


def read(readings):
    return roofline_pct(readings, "ct_scan_block", names.load_module("roofline", "ct_scan_block").work)
