"""Visualization: headless equivalents of the reference's Pangolin stack.

Reference: src/Viewer.cc (GL window + menu loop), src/FrameDrawer.cc
(annotated camera frame), src/MapDrawer.cc (3D map/graph/camera render),
Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.cc (plane detection + cube overlay).

Counterpart of c_orb_slam_tpu/viz/. SLAM runs headless: instead of a GL
loop, visualization renders to numpy images, matplotlib figures and
PNG + HTML reports from host copies of the map, decoupled from the
tracking loop (PIL and matplotlib are imported where they are used). The
same data feeds any external live viewer.
"""

from c_orb_slam_tpu_torch.viz.frame_drawer import FrameDrawer
from c_orb_slam_tpu_torch.viz.map_drawer import MapDrawer
from c_orb_slam_tpu_torch.viz.viewer import Viewer

__all__ = ["FrameDrawer", "MapDrawer", "Viewer"]
