"""gdslam_tpu — dynamic RGB-D SLAM in JAX.

A from-scratch JAX/XLA re-design of the capabilities of GD-SLAM
(DynaSLAM / ORB-SLAM2 + dense-scene-flow dynamic masking): ORB pyramid
front-end as fused jitted programs, per-pixel Mahalanobis scene-flow masking
as a single jitted transform, Gauss-Newton/LM pose & bundle adjustment on
fixed-shape map arenas, BoW place recognition as dense matrix products, and
an optional Flax Mask R-CNN for semantic masking — with batched
multi-sequence scale-out over a `jax.sharding.Mesh`.

Public API mirrors the reference's `ORB_SLAM2::System` (reference
include/System.h): see `gdslam_tpu.system.System`.
"""

__version__ = "0.1.0"

import os as _os

# Persistent XLA compilation cache. The fused per-frame programs take tens
# of seconds to compile, so later processes should find them cached. Where
# JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is set
# here. Otherwise the cache lives at the fixed `<checkout>/.jax_cache`: the
# path is part of each entry's key, so a directory that moves never hits.
# CPU-only runs (the test suite) keep no cache: XLA:CPU entries are pinned
# to the compiling host's CPU features.
CHECKOUT_CACHE_DIR = _os.path.normpath(_os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "..", ".jax_cache"))

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR") and \
        _os.environ.get("JAX_PLATFORMS", "").lower() != "cpu":
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)

from gdslam_tpu.config import SlamConfig, CameraConfig, OrbConfig  # noqa: E402,F401
