"""svo_tpu — a stereo visual-odometry / SLAM framework in JAX.

Built from scratch in JAX/XLA with the capabilities of the reference C++
pipeline (ikryukov/svo): FAST/ORB feature detection with spatial bucketing,
pyramidal KLT tracking (stereo matching + temporal tracking), DLT triangulation
into a persistent map, RANSAC-PnP pose estimation with outlier rejection,
keyframe-based map maintenance — plus the windowed Schur-complement bundle
adjustment the reference declared but never implemented
(reference: src/map.cpp:84-88).

Design stance (see SURVEY.md §7): arrays + pure functions. Frame state is a
fixed-capacity struct-of-arrays; the map is preallocated arrays with a monotone
allocation cursor; every per-frame stage is a jitted function state -> state;
variable-count semantics become masks, never dynamic shapes.
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry (PnP, triangulation, SE(3), BA) needs true f32 matmuls. On the
# GPU, XLA may otherwise run f32 matmuls in TF32 (about three decimal
# digits), which costs pixels of reprojection accuracy.
_jax.config.update("jax_default_matmul_precision", "float32")

# Persistent compilation cache: the pipeline step is a large program, and the
# cache makes every later process start warm. JAX reads
# JAX_COMPILATION_CACHE_DIR itself; without it the cache sits at a fixed path
# inside the checkout (the path is part of the cache key).
import os as _os

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )

from svo_tpu.config import Config, load_config  # noqa: F401
