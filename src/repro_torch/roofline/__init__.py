"""The port's roofline: one card's rates (``analysis.HW``), the counted
cost of a step (``op_cost``), the analytic floors of each cell
(``floors``) and the least time of each hand-written kernel's launch
(``kernels``)."""

from .analysis import HW, RooflineReport, analyze_counted, collective_bytes

__all__ = ["RooflineReport", "analyze_counted", "collective_bytes", "HW"]
