"""What depends on the platform, in one place.

- `configure()`: called first by every entry point (the two
  `train_video_*.py` scripts, `gsvc_tpu.decode`, `bench.py`,
  `chip_smoke.py`). It points JAX's persistent compile cache at a fixed
  directory inside the checkout, unless `JAX_COMPILATION_CACHE_DIR` is set,
  in which case JAX reads that itself and nothing is set here.
- `rasterizer_backend()`: what `backend="auto"` means — the per-tile
  Pallas/Triton kernel (ops/rasterize_tile.py) on a GPU, the plain-XLA
  binned rasterizer (ops/rasterize_binned.py) everywhere else. The
  interpreter is never chosen here; tests reach it by an explicit
  `interpret=True`.
- `require_gpu()`: measurement paths refuse to run without a GPU.
"""

from __future__ import annotations

import os
from pathlib import Path

# Fixed, so that a later run in the same checkout finds what an earlier one
# compiled (the path is part of the cache key). Listed in .gitignore.
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir() -> str | None:
    """The directory this module sets, or None when the environment
    already names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(CACHE_DIR)


def configure() -> None:
    import jax

    cache = compile_cache_dir()
    if cache is not None:
        jax.config.update("jax_compilation_cache_dir", cache)


def rasterizer_backend(platform: str | None = None) -> str:
    """'tile' on a GPU, 'binned' elsewhere."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    return "tile" if platform == "gpu" else "binned"


def require_gpu():
    """The first JAX device, or SystemExit when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found platform {dev.platform!r} "
            f"({dev.device_kind}); this measurement runs on the GPU only"
        )
    return dev
