"""texturefusion_torch — the PyTorch / CUDA port of texturefusion_tpu.

The JAX package beside it is the reference; this package mirrors its
module paths (core/, ops/, fusion/, io/, models/) so that each
counterpart is easy to find, and is held against it by the parity tests
`tests/test_torch_*.py`.

What runs so far is the ground-truth-pose slice of the main path:
packed RGB-D frame → preprocess (clamp, 9×9 bilateral, normals, grazing
refine, quality) → chunk discovery + slot allocation → TSDF voxel update
→ incremental marching cubes → PLY. Two hand-written CUDA kernels carry
it on the GPU (csrc/bilateral.cu, csrc/tsdf_integrate.cu, built and
bound by ops/cuda_kernels.py); every tensor on the CPU takes the plain
PyTorch version of the same function.

The package never imports jax. It shares the configuration dataclasses
of `texturefusion_tpu.config` (pure dataclasses, re-exported as
`texturefusion_torch.config`) and the source of the native chunk
allocator.
"""

__version__ = "0.1.0"

from texturefusion_torch.config import PipelineConfig  # noqa: F401
