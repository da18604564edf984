"""The pipeline configuration, shared with the JAX package.

`texturefusion_tpu.config` is pure dataclasses, and importing
`texturefusion_tpu` loads nothing else, so both packages read one set of
settings and a parity test hands the same object to each.
"""

from texturefusion_tpu.config import (  # noqa: F401
    BAConfig,
    CameraConfig,
    MeshConfig,
    ParallelConfig,
    PipelineConfig,
    TextureConfig,
    TrackingConfig,
    TSDFConfig,
    tiny_test_config,
)
