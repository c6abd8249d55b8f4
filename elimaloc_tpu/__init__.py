"""elimaloc_tpu — an EKF + LiDAR map-matching localization engine in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of ELiMaLoc
(EKF-based LiDAR-Inertial Map-matching Localization): motion deskewing, a
device-resident voxel-hash map, four ICP variants (P2P/GICP/VGICP/AVGICP),
and a 27-state error-state EKF fusing IMU/GNSS/CAN/map-matching — fused into
jitted per-event steps and replayed over logs instead of ROS topics.
"""

__version__ = "0.1.0"

import jax as _jax

# At default precision a GPU f32 matmul may run in TF32 (10 mantissa bits).
# Pose composes and frame transforms carry ~100 m translations whose TF32
# ulp is ~0.06 m — a sub-5 cm ICP step cannot change the pose (the compose
# rounds back to the same value), freezing registration at centimeter-to-
# decimeter error. Localization is a centimeters-at-map-scale product, so the
# package default is full-f32 matmuls; the large throughput-critical
# contractions (distance matrices, one-hot selections, GN accumulations)
# additionally carry explicit precision=HIGHEST so correctness never depends
# on this global.
_jax.config.update("jax_default_matmul_precision", "highest")

from . import config  # noqa: F401
from .config import (  # noqa: F401
    CalibConfig,
    ElimalocConfig,
    EkfConfig,
    GnssSource,
    GpsType,
    IcpMethod,
    PcmConfig,
    ShapeBudget,
)
