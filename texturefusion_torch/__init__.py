"""texturefusion_torch — the PyTorch / CUDA port of texturefusion_tpu.

The JAX package beside it is the reference; this package mirrors its
module paths (core/, ops/, fusion/, io/, models/, slam/, eval/) so that each
counterpart is easy to find, and is held against it by the parity tests
`tests/test_torch_*.py`.

What runs so far: the main path, as fusion/pipeline.TexturedPipeline
drives it: per frame, preprocess (clamp, 9×9 bilateral, normals, grazing
refine, quality), features and registration
(models/reconstruction.frame_step_tracked2) and the keyframe decisions,
loop closure and dense FastBA (slam/gcslam.GCSLAM); per keyframe, a
fusion cycle: drift reintegration, chunk discovery + slot allocation,
the TSDF voxel update of the keyframe and of its local frames,
incremental marching cubes, the texture stage (texture/: MRF view
selection, patch projection, atlas, colour compensation), GC, streaming;
then the PLY, the textured OBJ/MTL/PNG and the trajectory. Two
hand-written CUDA kernels carry it on the GPU
(csrc/bilateral.cu, csrc/tsdf_integrate.cu with its F-frame mode, built
and bound by ops/cuda_kernels.py); every tensor on the CPU takes the
plain PyTorch version of the same function.

parallel/ is the multi-device layer: a DeviceMesh of torch devices
driven by one process, the TSDF rows and the mesh pool sharded by chunk
slot (slot s on shard s % n), BA's edges sharded (distributed and Schur
Gauss-Newton), the multichip map cycle (models/reconstruction) and
dryrun_multichip.

The package never imports jax, nor anything of the JAX package: it
keeps its own copies of the configuration dataclasses (config.py) and of
the native chunk allocator (native.py, csrc/chunk_alloc.cpp).
"""

__version__ = "0.1.0"

from texturefusion_torch.config import PipelineConfig  # noqa: F401
from texturefusion_torch.fusion.pipeline import TexturedPipeline  # noqa: F401
