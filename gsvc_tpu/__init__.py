"""gsvc_tpu — a Gaussian-splat video codec framework in JAX.

A from-scratch JAX/Pallas rebuild of the capabilities of ac-freeman/GSVC
("Gaussian Splatting for Video Compression", arXiv 2501.12060):

- 2D Gaussian-splat image representation trained per video frame
  (reference: GaussianSplats_Represent.py).
- Differentiable sum-rasterizer over a 16x16 tile grid
  (reference: gsplat/gsplat/cuda/csrc/forward.cu:512 `rasterize_forward_sum`),
  implemented here as a per-tile Pallas kernel through Triton for NVIDIA
  GPUs (ops/rasterize_tile.py), a plain-XLA binned rasterizer that runs
  anywhere, and a dense XLA oracle.
- Adan optimizer (reference: optimizer.py), quantization-aware compression
  stage with uniform/vector quantizers and ANS entropy coding
  (reference: quantize.py, GaussianSplats_Compress.py).
- Video drivers with K-frame detection, warm-starting, adaptive splat
  control (reference: train_video_Represent.py, train_video_Compress.py).
- NEW relative to the reference: a distributed layer — pixel/tile sharding
  across devices with psum'd splat gradients, and frame/GOP parallelism
  across processes, built on jax.sharding.Mesh + shard_map.

Design notes:
- Static shapes everywhere: splat counts live in fixed-size buffers with an
  `alive` mask; prune/add flips mask bits (reference reallocates tensors,
  GaussianSplats_Represent.py:109-128 — that would retrace under jit).
- The sum-render is order-independent (no depth sort exists in the math;
  reference depths are constant 0, foward2d.cu:67), so binning is a
  tile-membership CSR built with one XLA sort, and the kernel's backward
  writes per-intersection partial grads without conflicts; a segment_sum
  reduces them per splat. On the CPU that reduction runs in a fixed order
  (bitwise reproducible); on a GPU XLA's scatter-add uses atomics, like
  the reference's atomicAdd backward (PERF.md).
"""

__version__ = "0.1.0"

from gsvc_tpu.core import SplatParams  # noqa: F401
