"""Visualization / export utilities (reference GL layer equivalent).

The reference renders via OpenGL/GLUT with CL-GL buffer sharing
(CLEnvGL, src/ocl_icp_sbs.cpp:47-69) — there is no GL interop with the
accelerator here, so this module provides offline equivalents: PLY export
(icp_tpu.sensors.io.write_ply), matplotlib scatter snapshots, and
registration before/after composites.
"""

from icp_tpu.viz.live import LiveViewer
from icp_tpu.viz.plot import plot_cloud, plot_registration, plot_trajectory

__all__ = ["LiveViewer", "plot_cloud", "plot_registration",
           "plot_trajectory"]
